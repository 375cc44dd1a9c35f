"""Batched whole-token decode megakernel (PyTorch port of
``awq_tpu/ops/megakernel_batched.py``).

:func:`w4a16_llama_token_step_batched` runs ALL decoder layers for ``B``
rows, one token each, row ``b`` at its own position ``lengths[b]``, plus
(optionally) the final RMSNorm and the W4 head, in ONE launch of kernel K6
(``csrc/megakernel_batched.cu``): the decode step of the
continuous-batching engine. Every weight is streamed once for all rows.

The arithmetic follows the JAX kernel's (``_btoken_kernel``), rounding
points included: every matmul consumes ``bf16(x)`` with per-group scale
and szero corrections in f32; the QKV output is rounded to bf16, the bias
added and the sum rounded again (the JAX kernel's g-major and b-major bf16
scratch); gate/up are rounded to bf16 and ``hm = bf16(silu(gate) * up)``;
the residual is f32 within a layer and rounded to bf16 between layers.
Each row's current k/v enter its own attention in f32.

JAX returns the new k/v and its caller scatters them into the cache. Here,
as in K4 and K5, the kernel (or the plain version on the CPU) writes them
IN PLACE at ``cache[l, :, b, :, lengths[b]]`` and returns them too, in the
cache dtype, so a step is one launch with no append after it. A length
outside ``[0, T)`` is clamped into it, as the JAX append clamps.

Paged mode (``tables [B, MP]`` int32 page ids): ``cache`` is then a page
pool ``[L, 2, NP, nkv, page, hd]`` shared by all rows, and row ``b``'s
position ``p`` lives at page ``tables[b, p // page]``, offset ``p % page``.
K6 reads and writes through the table; everything else is the same step.
The length is clamped into ``[0, MP * page)``.

int8 KV (``cache_scales [L, 2, B, nkv, T]`` f32 beside an int8 cache, the
JAX kernel's operand; its ``[.., T//256, 256]`` form is taken too, as the
reshape it is): slot mode only, as in JAX, whose paged gate refuses an int8
pool (``megakernel_batched.py:518``); paged mode with ``cache_scales``
raises ``NotImplementedError``. The attention dequantizes each prefix
position elementwise; the new k/v come back in bf16 and the in-place write
stores ``quantize_kv`` of them, as JAX's caller appends them
(``models/llama.py:1141-1154``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from awq_tpu_torch.ops.decode_attn import gather_pages
from awq_tpu_torch.ops.cache_append import dequantize_kv
from awq_tpu_torch.ops.megakernel import (
    HEAD_DIM,
    _CACHE_CODE,
    _DTYPE_CODE,
    _fail,
    check_operands,
    check_small,
    head_operands,
    kv_out_dtype,
    launch,
    megakernel_supported,
    model_shape,
    qdot_layer,
    qlinear_ptrs,
    rms_rows,
    rope_rows,
    write_kv,
)
from awq_tpu_torch.ops.w4a16 import QLinear

#: Launches of K6 over a slot cache, over a page pool and over an int8 slot
#: cache, in W4 and in W3 mode, counted where the wrapper launches it.
LAUNCHES = {f"megakernel_batched{m}{w}": 0 for m in ("", "_paged", "_int8")
            for w in ("", "_w3")}
_INSTANCE = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
             torch.int8: "int8"}

MIN_B, MAX_B = 2, 64      # rows per launch (one row is K4's case)

# ---- K6's schedule (and K5's, the chunk mode of the same body): the kernel
# runs this plan (_plan_ints, _layout_ints), and plan_for in
# csrc/megakernel_batched.cu refuses one that does not fit its build ----
WARPS = 8                 # consumer warps a block; one producer warp more
THREADS = 32 * (WARPS + 1)
SMEM_MAX = 232448         # dynamic shared memory a block may take (227 KB)
RING_BYTES = 60 * 1024    # code and scale bytes a block keeps in flight, at most
WARP_ROWS = 32            # rows a consumer warp sums (four n8 tiles)
RED_BYTES = WARPS * 16 * WARP_ROWS * 4      # the warps' partial sums of a wave
RS_BYTES = 64 * 4                           # each row's rmsnorm factor
KV_RING_BYTES = 8448      # a warp's ring of k/v rows in the attention
ATT_BYTES = (4 * (8 * 128 + 2 * 128 + 2 * WARPS * 8 + WARPS * 8 * 128 + WARPS)
             + WARPS * KV_RING_BYTES)
# K5 (chunk mode): window rows, a block's sums of a wave that its cluster
# reads, and the attention's q (hi and lo, 128 rows), the window's k (hi and
# lo) and v (32 rows each) and its K (hi and lo) and V tiles of TP positions
# in two stages, 16-bit elements
CHUNK_ROWS = 32
TOT_BYTES = WARPS * 16 * WARP_ROWS * 4
TP = 32
CHUNK_ATT_BYTES = (2 * 128 + 3 * 32 + 2 * 3 * TP) * 128 * 2
#: The regions of a block's shared memory, in the order _layout_ints gives
#: their byte offsets (the ring starts at the first 128-byte boundary).
REGIONS = ("bars", "red", "rs", "xsum", "rows", "att", "tot")


def chunk_channels(w3: bool) -> int:
    """Input channels of one ring stage: a W4 group (16 code rows) or a W3
    packing chunk of two groups (24 rows)."""
    return 256 if w3 else 128


def stage_bytes(w3: bool) -> int:
    """One ring slot: a round of a wave, at most one piece for each of the
    eight consumer warps (a piece is a chunk's code rows for 16 columns and
    the scale and szero rows of its groups), and 1 KB for the 128-byte
    alignment of its TMA boxes."""
    rows, groups = (24, 2) if w3 else (16, 1)
    return WARPS * (rows + 2 * groups) * 16 * 4 + 1024


def smem_layout(b: int, w3: bool, wc: int, chunk: bool = False) -> dict:
    """The shared memory of a block with ``b`` rows and windows of ``wc``
    chunks, the one source of its layout (the kernel carves from these
    offsets and checks their alignment and room, and that the regions at an
    offset its build fixes, up to the norm factors, lie there): the ring
    (after up to 128 bytes of alignment) and its mbarriers (full and empty a slot,
    the rows' bulk copies; K5 two more, its cluster merge), then the warps'
    partial sums, the norm factors, the window's group sums and rows (bf16
    pairs, 16 bytes of padding a row) and, in K5, the sums its cluster
    reads. The attention reuses the region from the partial sums on."""
    bp = -(-b // 8) * 8
    sb = stage_bytes(w3)
    slots = RING_BYTES // sb
    kc = chunk_channels(w3)
    bars = 128 + slots * sb
    red = -(-(bars + 8 * (2 * slots + 1 + 2 * int(chunk))) // 128) * 128
    rs = red + RED_BYTES
    xsum = rs + RS_BYTES
    rows = -(-(xsum + bp * (wc * kc // 128) * 4) // 16) * 16
    end = rows + bp * (wc * kc // 2 + 8) * 4
    tot = end if chunk else 0
    end += TOT_BYTES if chunk else 0
    att = CHUNK_ATT_BYTES if chunk else ATT_BYTES
    return dict(bars=bars, red=red, rs=rs, xsum=xsum, rows=rows, att=red, tot=tot,
                smem=max(end, red + att), slots=slots)


def _smem(b: int, w3: bool, wc: int):
    """K6's shared bytes and ring slots for windows of ``wc`` chunks."""
    lay = smem_layout(b, w3, wc)
    return lay["smem"], lay["slots"]


WAVE_ROUNDS = 6           # K5: what a wave's end (its cluster merge) costs, in ring rounds


def _chunk_wave(tmax: int, u: int, rh: int, nchq: int, nw: int):
    """K5's wave and warps a tile: the least time over a block's tiles, a
    wave's rounds (each busy warp a chunk a round) and its cluster merge
    (``WAVE_ROUNDS``) times the waves, the larger wave on a tie; no wave
    holds more tiles than a block has, so no box reads past them."""
    best = None
    for wave in range(u, min(WARPS // rh, tmax) + 1, u):
        k = WARPS // rh // wave
        per = -(-nchq // nw)
        cost = -(-tmax // wave) * (nw * -(-per // k) + WAVE_ROUNDS)
        if best is None or cost <= best[0]:
            best = (cost, wave, k)
    return best[1], best[2]


def batched_plan(b: int, H: int, inter: int, nq: int, nkv: int, vocab: int, w3: bool,
                 grid: int, cluster: int = 0) -> dict:
    """K6's schedule for ``b`` rows on a cooperative grid of ``grid`` blocks
    (one an SM): the shared bytes and ring slots of a block, the window of
    input channels whose rows a block stages at once, and for each matmul
    phase its tile units (16 output columns; gate/up's unit a pair of gate
    and up blocks), which units each block takes, how many tiles a wave
    holds, how many warps split a tile's chunks and the windows over IC.
    The wrapper hands the kernel this plan (``_plan_ints``) and the layout's
    region offsets (``_layout_ints``); the C side (``plan_for``) refuses a
    region misaligned or too small for what its build puts there, more warps
    than a block has, a window larger than the rows' room or a TMA box over
    256.

    ``cluster`` > 0 is K5's plan (the chunk mode, ``vocab`` 0, 1..32 rows):
    the grid is ``grid / cluster`` thread-block clusters; a phase's units go
    to clusters in equal runs, each block of a cluster (its rank) takes the
    same units over its own run of IC's chunks (``ranks``), and the ranks'
    sums meet in rank order at each wave's end. The wave and warps a tile
    are those of the least time (``_chunk_wave``)."""
    chunk = cluster > 0
    lo, hi = (1, CHUNK_ROWS) if chunk else (MIN_B, MAX_B)
    if not lo <= b <= hi:
        raise ValueError(f"{b} rows; the kernel takes {lo}..{hi}")
    if chunk and vocab:
        raise ValueError("K5 has no head")
    C = max(cluster, 1)
    if grid < C or grid % C:
        raise ValueError(f"a grid of {grid} blocks is not whole clusters of {C}")
    ncl = grid // C
    kc = chunk_channels(w3)
    if chunk and C > min(H, inter) // kc:
        raise ValueError(f"clusters of {C} split IC finer than its {min(H, inter) // kc} chunks")
    most = -(-max(H, inter) // kc // C)
    wc = 0
    for c in range(most, 0, -1):
        if smem_layout(b, w3, c, chunk)["smem"] <= SMEM_MAX:
            wc = c
            break
    if not wc:
        raise ValueError(f"{b} rows do not fit a block's shared memory")
    lay = smem_layout(b, w3, wc, chunk)
    rh = -(-b // WARP_ROWS)
    oq = (nq + 2 * nkv) * 128
    phases = {}
    for name, ic, oc, u in (("qkv", H, oq, 1), ("o", H, H, 1), ("gateup", H, 2 * inter, 2),
                            ("down", inter, H, 1), ("head", H, vocab, 1)):
        if not oc:
            continue
        units = oc // 16 // u
        per = [(g * units // ncl, (g + 1) * units // ncl) for g in range(ncl)]
        tmax = -(-units // ncl) * u
        nch = ic // kc
        ranks = [(q * nch // C, (q + 1) * nch // C) for q in range(C)]
        nchq = max(c1 - c0 for c0, c1 in ranks)
        nw = -(-nchq // wc)
        if chunk:
            wave, k = _chunk_wave(tmax, u, rh, nchq, nw)
        else:
            wave = min(WARPS // rh, tmax)
            wave -= wave % u
            k = WARPS // rh // wave
        phases[name] = dict(ic=ic, oc=oc, unit=u, units=units, blocks=per, wave=wave,
                            k=k, nch=nch, windows=nw, ranks=ranks,
                            window_chunks=[(w * nchq // nw, (w + 1) * nchq // nw)
                                           for w in range(nw)])
    return dict(grid=grid, threads=THREADS, smem=lay["smem"], slots=lay["slots"], window=wc,
                chunk=kc, stage_bytes=stage_bytes(w3), row_halves=rh, phases=phases,
                cluster=C, layout=lay)


def rank_windows(ph: dict, q: int) -> list:
    """The windows of rank ``q`` over a phase's chunks, as absolute chunk
    ranges: rank q's run of chunks cut as the kernel cuts it."""
    c0, c1 = ph["ranks"][q]
    n, nw = c1 - c0, ph["windows"]
    return [(c0 + w * n // nw, c0 + (w + 1) * n // nw) for w in range(nw)]


@functools.lru_cache(maxsize=None)
def _plan_ints(b, H, inter, nq, nkv, vocab, w3, grid) -> tuple:
    """``batched_plan`` as the kernel takes it, once per shape: the grid,
    shared bytes, ring slots and window, then each matmul phase's wave,
    warps a tile and windows (qkv, o-proj, gate/up, down, head; zeros for
    an absent head). The C side runs this plan and refuses one that does
    not fit its build."""
    plan = batched_plan(b, H, inter, nq, nkv, vocab, w3, grid)
    return _phase_ints(plan)


def _phase_ints(plan) -> tuple:
    pp = []
    for name in ("qkv", "o", "gateup", "down", "head"):
        ph = plan["phases"].get(name)
        pp += [ph["wave"], ph["k"], ph["windows"]] if ph else [0, 0, 0]
    return (plan["grid"], plan["smem"], plan["slots"], plan["window"], *pp)


@functools.lru_cache(maxsize=None)
def _layout_ints(b, w3, wc, chunk=False) -> tuple:
    """The byte offsets of the shared-memory regions (``REGIONS``) that the
    kernel carves, from ``smem_layout``."""
    lay = smem_layout(b, w3, wc, chunk)
    return tuple(lay[r] for r in REGIONS)


def chunk_slices(s: int, hist: int, nq: int, nkv: int, grid: int):
    """K5's attention items over the window's positions ``[0, hist + s)``:
    ``(row blocks, slices, slice length)``. An item is a kv head's block of
    up to 128 packed (window row, head) query rows over a slice, about one
    item a block, each slice whole tiles of ``TP`` positions."""
    npos = hist + s
    nrb = -(-(s * (nq // nkv)) // 128)
    ns = max(1, grid // (nkv * nrb))
    ns = min(ns, -(-npos // TP))
    split = -(-(-(-npos // ns)) // TP) * TP
    return nrb, -(-npos // split), split


@functools.lru_cache(maxsize=None)
def _chunk_plan_ints(s, H, inter, nq, nkv, w3, grid, cluster) -> tuple:
    """K5's plan as the kernel takes it, once per shape: ``_plan_ints``'s
    fields, the region offsets and the cluster size."""
    plan = batched_plan(s, H, inter, nq, nkv, 0, w3, grid, cluster=cluster)
    return (*_phase_ints(plan), *_layout_ints(s, w3, plan["window"], True), plan["cluster"])


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sm_count(dev) -> int:
    dev = torch.device(dev)
    return _sms(torch.cuda.current_device() if dev.index is None else dev.index)


def megakernel_batched_supported(cfg, layers, cache, batch: int) -> bool:
    """Whether ``decode_step_batched`` takes K6: the single-token gate
    (:func:`~awq_tpu_torch.ops.megakernel.megakernel_supported`) over a
    cache of ``batch`` slots, with 2..64 rows. The JAX gate's ``B % 8`` and
    its VMEM budget are facts of Mosaic's (8, 128) tiles and of the TPU's
    scratch memory: K6 takes any row count (rows fill ``mma`` tiles of 16,
    in passes of 32) and keeps its activations in device memory."""
    if not MIN_B <= batch <= MAX_B or model_shape(cfg) != "llama":
        return False
    return megakernel_supported(cfg, layers, cache, slots=batch)


def megakernel_paged_supported(cfg, layers, pool, batch: int) -> bool:
    """Whether ``decode_step_paged`` takes K6's paged mode: 2..64 rows, as
    the slot gate, over a page pool ``[L, 2, NP, nkv, page, hd]`` under the
    single-token gate, with a page size that is a power of two. K6 looks up
    the page of every position it reads or writes (a shift and a mask), so
    it takes any such page size; the JAX gate's ``page == 256`` and ``B %
    8`` are its (8, 128) tiles and its ``bt``-sized DMA blocks. The card's
    paged instance is built for bf16, the engine's pool dtype: its wrapper
    refuses another (the plain version takes any float pool). An int8 pool
    is refused, as the JAX gate refuses it: there is no paged int8 cache."""
    if (isinstance(pool, tuple) or not MIN_B <= batch <= MAX_B or pool.dim() != 6
            or model_shape(cfg) != "llama"):
        return False
    page = pool.shape[4]
    if page < 1 or page & (page - 1):
        return False
    return megakernel_supported(cfg, layers, pool, slots=pool.shape[2])


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _scales_view(cache, cache_scales, tables):
    """``cache_scales`` as ``[L, 2, B, nkv, T]`` (JAX's ``[.., T//256, 256]``
    reshaped), or None; int8 KV in paged mode raises."""
    if cache_scales is None:
        return None
    if cache.dtype != torch.int8:
        _fail("megakernel_batched", f"cache_scales with a {cache.dtype} cache")
    if tables is not None:
        raise NotImplementedError(
            "megakernel_batched: int8 KV over a page pool; the JAX package has no "
            "paged int8 cache either (awq_tpu/runtime/paged.py:107-109, "
            "ops/megakernel_batched.py:518)")
    return cache_scales.reshape(tuple(cache_scales.shape[:4]) + (-1,))


class _Rows:
    """Where each row's k/v live: slot ``b`` of a slot cache (codes and
    ``scales`` for int8), or the pages ``tables[b]`` of a pool. ``read(l,
    n)`` is ``[2, B, nkv, n, hd]`` f32, the first ``n`` positions of every
    row in layer ``l``, dequantized; ``write(l, x)`` puts ``x [2, B, nkv,
    hd]`` at each row's position."""

    def __init__(self, cache, lengths, tables, scales=None):
        dev = cache.device
        self.cache, self.scales, self.page = cache, scales, cache.shape[4]
        rows = torch.arange(lengths.shape[0], device=dev)
        t = self.page if tables is None else tables.shape[1] * self.page
        self.lens = lengths.to(device=dev, dtype=torch.long).clamp(0, t - 1)
        if tables is None:
            self.tables, self.where, self.pos = None, rows, self.lens
        else:
            self.tables = tables.to(dev).long()
            self.where = self.tables[rows, self.lens // self.page]
            self.pos = self.lens % self.page

    def read(self, l, n):
        if self.scales is not None:
            return dequantize_kv(self.cache[l, :, :, :, :n], self.scales[l, :, :, :, :n])
        if self.tables is None:
            return self.cache[l, :, :, :, :n].float()
        return gather_pages(self.cache, self.tables, l,
                            -(-n // self.page))[..., :n, :].float()

    def write(self, l, x):
        # cache[l, :, where[b], :, pos[b]] is [B, 2, nkv, hd]
        write_kv(self.cache, self.scales, (l, slice(None), self.where, slice(None), self.pos),
                 x.transpose(0, 1))


def w4a16_llama_token_step_batched_plain(
        h, wqkv, wo, wgu, wdn, ln1, ln2, cos_rows, sin_rows, cache, lengths,
        nq, nkv, eps=1e-5, whead: Optional[QLinear] = None,
        norm_w: Optional[torch.Tensor] = None, cache_scales=None, tables=None,
        max_length: Optional[int] = None):
    """Plain version of K6: ``(h_new [B, H] in h.dtype, k_new, v_new
    [L, B, nkv, hd] in the cache dtype, bf16 for int8)`` plus ``logits
    [B, V]`` f32 with a head; writes the cache (or the pool, with
    ``tables``) at each row's length in every layer."""
    scales = _scales_view(cache, cache_scales, tables)
    hd = HEAD_DIM
    b = h.shape[0]
    grp = nq // nkv
    dev = cache.device
    kv_at = _Rows(cache, lengths, tables, scales)
    lens = kv_at.lens
    tmax = int(lens.max())      # max_length is the kernel's grid hint only
    live = torch.arange(tmax, device=dev)[None, :] < lens[:, None]      # [B, tmax]
    cos, sin = cos_rows.float()[:, None, :], sin_rows.float()[:, None, :]
    hh = h.float()
    ks, vs = [], []
    for l in range(cache.shape[0]):
        qkv = _bf16(qdot_layer(wqkv, l, rms_rows(hh, ln1[l], eps)))
        if wqkv.bias is not None:
            qkv = _bf16(qkv + wqkv.bias[l].float())
        q = rope_rows(qkv[:, :nq * hd].reshape(b, nq, hd), cos, sin)
        k = rope_rows(qkv[:, nq * hd:(nq + nkv) * hd].reshape(b, nkv, hd), cos, sin)
        v = qkv[:, (nq + nkv) * hd:].reshape(b, nkv, hd)
        qs = (q * (1.0 / math.sqrt(hd))).reshape(b, nkv, grp, hd)
        kc, vc = kv_at.read(l, tmax)
        sc = torch.einsum("bkgh,bkth->bkgt", qs, kc)
        sc = sc.masked_fill(~live[:, None, None, :], float("-inf"))
        s_cur = torch.einsum("bkgh,bkh->bkg", qs, k)[..., None]
        p = torch.softmax(torch.cat([sc, s_cur], dim=-1), dim=-1)
        attn = (torch.einsum("bkgt,bkth->bkgh", p[..., :tmax], vc)
                + p[..., tmax:] * v[:, :, None, :])
        kv_at.write(l, torch.stack([k, v]))
        h1 = hh + qdot_layer(wo, l, attn.reshape(b, nq * hd))
        gu = _bf16(qdot_layer(wgu, l, rms_rows(h1, ln2[l], eps)))
        gate, up = gu.chunk(2, dim=-1)
        hm = _bf16(gate * torch.sigmoid(gate) * up)
        hh = _bf16(h1 + qdot_layer(wdn, l, hm))
        ks.append(k)
        vs.append(v)
    kt = kv_out_dtype(cache)
    out = (hh.to(h.dtype), torch.stack(ks).to(kt), torch.stack(vs).to(kt))
    if whead is None:
        return out
    xf = rms_rows(hh, norm_w, eps)
    return out + (qdot_layer(whead, None, xf),)


def w4a16_llama_token_step_batched(
        h, wqkv, wo, wgu, wdn, ln1, ln2, cos_rows, sin_rows, cache, lengths,
        nq, nkv, eps=1e-5, whead: Optional[QLinear] = None,
        norm_w: Optional[torch.Tensor] = None, cache_scales=None, tables=None,
        max_length: Optional[int] = None):
    """All decoder layers for the ``B`` rows ``h [B, H]`` in one launch of
    K6; with ``whead``/``norm_w`` also the final RMSNorm and the W4 head.

    ``cos_rows``/``sin_rows [B, hd]`` f32 are the rope rows at each row's
    position, ``cache [L, 2, B, nkv, T, hd]``, ``lengths [B]`` int32 on the
    cache's device (read there: no host sync). With ``tables [B, MP]`` int32
    on that device (page ids in ``[0, NP)``: not checked, that would take a
    sync), ``cache`` is a bf16 pool ``[L, 2, NP, nkv, page, hd]`` and
    ``T = MP * page``. An int8 slot cache comes with ``cache_scales [L, 2,
    B, nkv, T]`` f32 (its k/v come back bf16). ``max_length``, about
    ``lengths.max()``, sizes the attention slices (a wrong value costs load
    balance, not correctness); the engine passes it from its host copy of
    the lengths, and without it the slices are sized for a full cache
    (``T - 1``). Returns ``(h_new [B, H], k_new
    [L, B, nkv, hd], v_new)`` (+ ``logits [B, V]`` f32); the cache is
    written at ``lengths[b]`` of slot ``b`` in every layer."""
    if cache.device.type == "cpu":
        return w4a16_llama_token_step_batched_plain(
            h, wqkv, wo, wgu, wdn, ln1, ln2, cos_rows, sin_rows, cache, lengths,
            nq, nkv, eps, whead, norm_w, cache_scales, tables, max_length)
    scales = _scales_view(cache, cache_scales, tables)
    paged = tables is not None
    what = ("megakernel_batched_paged" if paged else
            "megakernel_batched_int8" if scales is not None else "megakernel_batched")
    dev = cache.device
    if not cache.is_cuda:
        _fail(what, f"unsupported device {dev}")
    b = h.shape[0]
    if not MIN_B <= b <= MAX_B:
        _fail(what, f"{b} rows; the kernel takes {MIN_B}..{MAX_B}")
    L, H, inter, w3 = check_operands(what, h, (wqkv, wo, wgu, wdn), ln1, ln2,
                                     cache, nq, nkv, b,
                                     slots=cache.shape[2] if paged else b, scales=scales)
    page_ints = [0, 0, 0]
    T = cache.shape[4]
    if paged:
        if cache.dtype != torch.bfloat16:
            _fail(what, f"the pool must be bfloat16, got {cache.dtype}")
        if tables.dim() != 2 or tables.shape[0] != b or tables.shape[1] < 1:
            _fail(what, f"tables must be int32 [{b}, MP]")
        if T & (T - 1):
            _fail(what, f"page size {T}: the kernel takes powers of two")
        check_small(what, dev, torch.int32, tables=tables)
        page_ints = [cache.shape[2], T, tables.shape[1]]
        T = T * tables.shape[1]
    check_small(what, dev, None, h=h, ln1=ln1, ln2=ln2, cache=cache)
    check_small(what, dev, torch.float32, cos_rows=cos_rows, sin_rows=sin_rows)
    check_small(what, dev, torch.int32, lengths=lengths)
    if tuple(cos_rows.shape) != (b, HEAD_DIM) or tuple(sin_rows.shape) != (b, HEAD_DIM):
        _fail(what, f"cos/sin rows must be [{b}, {HEAD_DIM}]")
    if tuple(lengths.shape) != (b,):
        _fail(what, f"lengths must be int32 [{b}]")
    max_length = T - 1 if max_length is None else min(max(int(max_length), 0), T - 1)
    bias = wqkv.bias
    check_small(what, dev, h.dtype, bias=bias, norm_w=norm_w)
    vocab, head, logits = head_operands(what, whead, norm_w, H, b, dev, w3)
    out = torch.empty_like(h)
    k_new = torch.empty((L, b, nkv, HEAD_DIM), dtype=kv_out_dtype(cache), device=dev)
    v_new = torch.empty_like(k_new)
    ptrs = ([h.data_ptr(), out.data_ptr()]
            + qlinear_ptrs(wqkv, dev) + [bias.data_ptr() if bias is not None else 0]
            + qlinear_ptrs(wo, dev) + qlinear_ptrs(wgu, dev) + qlinear_ptrs(wdn, dev)
            + [ln1.data_ptr(), ln2.data_ptr(), cos_rows.data_ptr(),
               sin_rows.data_ptr(), cache.data_ptr(), k_new.data_ptr(),
               v_new.data_ptr(), lengths.data_ptr()]
            + head + [logits.data_ptr() if logits is not None else 0]
            + [tables.data_ptr() if paged else 0,
               scales.data_ptr() if scales is not None else 0])
    plan = _plan_ints(b, H, inter, nq, nkv, vocab, w3, _sm_count(dev))
    # the plan, the region offsets, then K5's cluster, hist and slices (K6: 1, 0, 0, 0)
    ints = [b, L, H, inter, nq, nkv, T, max_length, vocab, _DTYPE_CODE[h.dtype],
            _CACHE_CODE[cache.dtype], int(bias is not None)] + page_ints + [
                int(w3), *plan, *_layout_ints(b, w3, plan[3]), 1, 0, 0, 0]
    unit = ("megakernel_batched_" + ("paged" if paged else _INSTANCE[cache.dtype])
            + ("_w3" if w3 else ""))
    launch("awq_mega_batched", unit, ptrs, ints, eps, dev)
    LAUNCHES[what + ("_w3" if w3 else "")] += 1
    res = (out, k_new, v_new)
    return res + ((logits,) if logits is not None else ())
