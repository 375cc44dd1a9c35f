"""Whole-token and whole-layer W4A16 decode megakernels (PyTorch port of
``awq_tpu/ops/megakernel.py``).

:func:`w4a16_llama_token_step` runs ALL decoder layers of a llama-family
model for one token, plus (optionally) the final RMSNorm and the W4 head,
in ONE launch of kernel K4 (``csrc/megakernel.cu``). Per layer: RMSNorm ->
fused QKV (+ bias) -> rope -> GQA attention over the cache prefix
``[0, length)`` plus the current token -> o-proj + residual -> RMSNorm ->
gate/up -> SiLU·mul -> down + residual. :func:`w4a16_llama_layer_step` is
the same kernel over one layer ``[l, l+1)``.

The arithmetic follows the JAX kernel's (``_token_kernel``, ``unpack=
"pscratch3"``), rounding points included:

- every matmul consumes ``bf16(x)``: per output column and group ``g``,
  ``s_g * sum(bf16(x) * q) - sz_g * sum(bf16(x))`` with f32 sums;
- norms, rope, softmax, SiLU and the residual run in f32; the current
  token's k/v stay f32 for its own attention;
- the residual is rounded to bf16 between layers only (token step).

Unlike JAX, the new k/v are written into the cache IN PLACE at position
``length`` of each layer (by the kernel; by the plain version on the
CPU); the functions still return them, as JAX does, in the cache dtype.

int8 KV (``cache_scales``, the JAX kernels' operand of that name): the
cache is a ``KVCache8``'s int8 codes ``[L, 2, 1, nkv, T, hd]`` with f32
``cache_scales [L, 2, 1, nkv, T]``. The attention dequantizes each prefix
position elementwise (``f32(code) * scale``) and the current token stays
f32, as in the JAX kernel (``megakernel.py:512-536``). The new k/v come
back in bf16 (JAX's ``kv_dt``), and the in-place write stores
:func:`~awq_tpu_torch.ops.cache_append.quantize_kv` of those bf16 values,
codes and scale, which is what JAX's caller appends
(``models/llama.py:765-774``).

W3 (the JAX kernels' ``unpack="dense3"``): every fused linear, and the
head when it runs in the kernel, holds ``pack_int3`` codes (``dense3``
QLinears, g128). K4 reads them as stored in its W3 mode, 0.375 B per
weight; the plain versions unpack them with ``unpack_int3``. The rounding
points are the W4 ones.

The MPT shape (``shape="mpt"``, the JAX kernel's ``norm="layernorm"``,
``act="gelu"``, ``pos_embed="alibi"``; units ``megakernel_mpt`` and
``megakernel_mpt_w3``, the shape a compile-time define as the format is):
bias-free LayerNorm (mean, then the variance of the centred row, in f32)
for both norms and the final one; no rope; ALiBi slopes ``2^(-8 (h + 1) /
nq)`` computed from the head index (:func:`mpt_slopes`; ``nq`` a power of
two), ``slope * t`` added to the score of position ``t``, the current
token's at ``length``; the MLP ``down(gelu(up(x)))`` with the exact erf
GELU, ``up`` an ``[L, H/8, I]`` stack in ``wgateup``'s place. K12 and K13
take no MPT shape, as in JAX.

Each function has a plain PyTorch version (``*_plain``): the CPU path and
the reference the kernel is held to on the card. The wrappers run the
plain version for CPU tensors and launch K4 for CUDA tensors, or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import os
from typing import Optional

import torch

from awq_tpu_torch.ops.cache_append import dequantize_kv, quantize_kv
from awq_tpu_torch.ops.w4a16 import QLinear, unpack_codes

#: Launches of K4's two entries, over a float cache and over an int8 one,
#: in W4 and in W3 mode, and of the MPT shape (float caches), counted where
#: the wrappers launch them.
LAUNCHES = {**{f"megakernel_{e}{w}{c}": 0 for e in ("token", "layer")
               for w in ("", "_w3") for c in ("", "_int8")},
            **{f"megakernel_{e}_mpt{w}": 0 for e in ("token", "layer") for w in ("", "_w3")}}
SHAPES = ("llama", "mpt")   # the layer bodies K4 is built for

GROUP = 128        # the group size the kernels are built for
HEAD_DIM = 128     # the head_dim the kernels are built for
MAX_GROUP = 8      # most q heads per kv head K4 takes (MK_MAXG)
CACHE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_CACHE_CODE = {**_DTYPE_CODE, torch.int8: 3}
# what a launch of csrc/megakernel.cu runs (its N_MODE): layers (K4), or one
# layer's attention half (K12) or MLP half (K13, ops/megakernel_tp.py)
MODE_LAYERS, MODE_ATT, MODE_MLP = 0, 1, 2


def split_cache(cache):
    """``(data, scales)`` of a KV cache: a ``KVCache8`` (the ``(data,
    scales)`` pair of ``models/llama.py``) or a float tensor, whose scales
    are None."""
    if isinstance(cache, tuple):
        return cache[0], cache[1]
    return cache, None


def kv_out_dtype(cache: torch.Tensor) -> torch.dtype:
    """The dtype the megakernels return k/v in: the cache's, or bf16 for an
    int8 cache (JAX's ``kv_dt``)."""
    return torch.bfloat16 if cache.dtype == torch.int8 else cache.dtype


# ---- gates -------------------------------------------------------------------

def _env(name: str) -> bool:
    return os.environ.get(name) == "1"


def weight_format(p) -> Optional[bool]:
    """The megakernels' format of a g128 :class:`QLinear`: False for W4 in
    ``pack_int4``, True for W3 in ``pack_int3`` (``dense3``), None for
    anything else (3-bit codes in the nibble container take the stacked
    path, as in JAX)."""
    if not isinstance(p, QLinear) or p.group_size != GROUP:
        return None
    if p.w_bit == 4 and not p.dense3:
        return False
    if p.w_bit == 3 and p.dense3:
        return True
    return None


def model_shape(cfg) -> Optional[str]:
    """K4's layer body for ``cfg``: ``"llama"`` (rope, RMSNorm, SwiGLU),
    ``"mpt"`` (ALiBi with a power-of-two head count, bias-free LayerNorm,
    the erf-GELU plain MLP, no embedding norm; JAX's ``mpt_shape``,
    ``awq_tpu/ops/megakernel.py:894-899``, its tanh-GELU variant left to
    the stacked path) or None. Either takes the sequential block over whole
    heads of 128."""
    if cfg.head_dim != HEAD_DIM or cfg.parallel_block or cfg.rotary_pct != 1.0:
        return None
    if cfg.act == "silu" and cfg.norm == "rmsnorm" and cfg.pos_embed == "rope":
        return "llama"
    if (cfg.act == "gelu" and cfg.norm == "layernorm" and cfg.pos_embed == "alibi"
            and cfg.num_heads & (cfg.num_heads - 1) == 0 and not cfg.embed_ln):
        return "mpt"
    return None


def megakernel_supported(cfg, layers, cache, slots: int = 1) -> bool:
    """Whether ``forward`` takes the megakernels for this model and cache
    (of ``slots`` batch rows: 1 for K4 and K5, B for the batched K6).

    Mirrors the JAX gates (``megakernel_supported`` and ``forward``'s
    conditions at ``models/llama.py:688-697``) with the TPU-only ones
    dropped: the folded/tiled layout, ``T % 256`` and the VMEM budget are
    facts of Mosaic's tiling and of a 16 MB VMEM; K4 reads ``pack_int4``
    as stored and keeps its activations in device memory. What K4 needs
    instead: the llama shape, head_dim 128, at most 8 q heads per kv head,
    group 128 on the four fused stacked linears, all W4 or all W3 in
    ``pack_int3`` (a uniform stack, as JAX's gate at
    ``awq_tpu/ops/megakernel.py:909-923``), a bias on ``wqkv`` only, a
    float cache of batch 1 on CUDA (``AWQ_TPU_FORCE_MEGAKERNEL=1`` lets the
    plain version run on the CPU, the JAX test hook);
    ``AWQ_TPU_DISABLE_MEGAKERNEL=1`` turns it off. An int8 ``KVCache8`` is
    taken with its scales (a bare int8 tensor is not). K4's MPT shape
    (:func:`model_shape`, batch 1 only) takes ``up`` in ``wgateup``'s place,
    no LayerNorm bias (``ln1_b``) and a float cache: JAX never gives K4 an
    ALiBi int8 cache (``awq_tpu/models/llama.py:681``).
    """
    if _env("AWQ_TPU_DISABLE_MEGAKERNEL"):
        return False
    cache, scales = split_cache(cache)
    if not isinstance(cache, torch.Tensor):
        return False
    if scales is None and cache.dtype not in CACHE_DTYPES:
        return False
    if scales is not None and (cache.dtype != torch.int8
                               or tuple(scales.shape) != tuple(cache.shape[:5])):
        return False
    if not (cache.is_cuda or _env("AWQ_TPU_FORCE_MEGAKERNEL")):
        return False
    if cache.dim() != 6 or cache.shape[2] != slots:
        return False
    shape = model_shape(cfg)
    if (shape is None or cfg.num_heads % cfg.num_kv_heads
            or cfg.num_heads // cfg.num_kv_heads > MAX_GROUP):
        return False
    if shape == "mpt" and (slots != 1 or scales is not None or "ln1_b" in layers
                           or "ln2_b" in layers):
        return False
    if cfg.hidden_size % GROUP or cfg.intermediate_size % GROUP:
        return False
    fmt = weight_format(layers.get("wqkv"))
    for name in ("wqkv", "wo", "wgateup" if shape == "llama" else "up", "down"):
        p = layers.get(name)
        if not isinstance(p, QLinear) or p.qweight.dim() != 3:
            return False
        if fmt is None or weight_format(p) != fmt:
            return False
        if p.bias is not None and name != "wqkv":
            return False
    return True


def head_in_kernel(params) -> bool:
    """The final norm and head run as the megakernels' last phase when the
    head is a 2-D g128 :class:`QLinear` without bias (``quantize_head``),
    in the body's format (a W3 head only with a W3 body, as JAX's
    ``models/llama.py:742``), whose vocabulary is a whole number of the
    kernels' 32-column tiles, and a final norm without bias (``norm_b``,
    ``awq_tpu/models/llama.py:735``)."""
    head = params.get("lm_head")
    body = params.get("layers", {}).get("wqkv")
    fmt = weight_format(head)
    return (fmt is not None and head.qweight.dim() == 2 and head.bias is None
            and params.get("norm_b") is None
            and head.out_features % 32 == 0
            and (body is None or weight_format(body) == fmt))


# ---- the schedule of K4's matmul phases (a host mirror of csrc/megakernel.cu) ------

TILE = 32            # output columns of a matmul tile
WARPS = 8            # warps of a block


@dataclasses.dataclass(frozen=True)
class MatmulPhase:
    """One matmul phase of a launch: ``name`` (``qkv``, ``o``, ``gu``,
    ``down``, ``head``), its layer, IC and OC, its 32-column tiles (gate/up:
    pairs of a gate tile and the up tile ``half`` columns on) and its
    128-channel groups."""

    name: str
    layer: int
    ic: int
    oc: int
    tiles: int
    ng: int
    half: int = 0


def matmul_phases(mode: int, n_layers: int, H: int, I: int, nq: int, nkv: int,
                  vocab: int = 0, shape: str = "llama"):
    """The matmul phases of one launch in order: per layer QKV and o-proj
    (K4, K12), gate/up (the MPT shape: ``up``, OC = I) and down (K4, K13),
    then K4's head."""
    oq, icq = (nq + 2 * nkv) * HEAD_DIM, nq * HEAD_DIM
    out = []
    for li in range(n_layers):
        if mode != MODE_MLP:
            out += [MatmulPhase("qkv", li, H, oq, oq // TILE, H // GROUP),
                    MatmulPhase("o", li, icq, H, H // TILE, icq // GROUP)]
        if mode != MODE_ATT:
            out += [MatmulPhase("up", li, H, I, I // TILE, H // GROUP) if shape == "mpt"
                    else MatmulPhase("gu", li, H, 2 * I, I // TILE, H // GROUP, I),
                    MatmulPhase("down", li, I, H, H // TILE, I // GROUP)]
    if mode == MODE_LAYERS and vocab:
        out.append(MatmulPhase("head", n_layers, H, vocab, vocab // TILE, H // GROUP))
    return out


def block_tiles(ph: MatmulPhase, b: int, nb: int):
    """The tiles block ``b`` of ``nb`` computes in a phase: ``b, b + nb, ...``"""
    return list(range(b, ph.tiles, nb))


def warp_loads(ph: MatmulPhase, b: int, nb: int, w: int):
    """The (tile column, group) loads of warp ``w`` of block ``b`` in a
    phase, in order: per tile (gate/up: the gate tile, then its up tile),
    groups ``w, w + 8, ...``; the warp requests each group's codes while it
    computes on the one before."""
    out = []
    for t in block_tiles(ph, b, nb):
        for col in ((t * TILE, ph.half + t * TILE) if ph.half else (t * TILE,)):
            out += [(col, g) for g in range(w, ph.ng, WARPS)]
    return out


# ---- plain versions ------------------------------------------------------------

def qdot_plain(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
               szeros: torch.Tensor, dense3: bool = False) -> torch.Tensor:
    """``x [M, IC]`` f32 -> ``[M, OC]`` f32 as the megakernels compute it:
    per group ``s * sum(bf16(x) * q) - sz * sum(bf16(x))``, f32 sums; the
    codes of ``pack_int4`` or, with ``dense3``, ``pack_int3``."""
    m, ic = x.shape
    ng = ic // GROUP
    xb = x.to(torch.bfloat16).float().reshape(m, ng, GROUP).transpose(0, 1)
    q = unpack_codes(qweight, dense3).reshape(ng, GROUP, -1)
    dot = torch.bmm(xb, q)                              # [ng, M, OC]
    xsum = xb.sum(dim=-1, keepdim=True)                 # [ng, M, 1]
    return (dot * scales.float()[:, None, :]
            - xsum * szeros.float()[:, None, :]).sum(dim=0)


def rms_rows(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Row-wise RMSNorm in f32 (``_rms_rows``): ``[M, H]``."""
    ms = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * w.float()


def ln_rows(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Row-wise bias-free LayerNorm in f32 (``_norm_rows(kind="layernorm")``):
    the mean, then the mean square of the centred row."""
    xc = x - torch.mean(x, dim=-1, keepdim=True)
    ms = torch.mean(xc * xc, dim=-1, keepdim=True)
    return xc * torch.rsqrt(ms + eps) * w.float()


def norm_rows(x: torch.Tensor, w: torch.Tensor, eps: float, shape: str = "llama"):
    """The layer body's norm: RMSNorm, or the MPT shape's LayerNorm."""
    return ln_rows(x, w, eps) if shape == "mpt" else rms_rows(x, w, eps)


def mpt_slopes(nq: int, device=None) -> torch.Tensor:
    """The MPT shape's ALiBi slopes as the kernels compute them from the head
    index (``_alibi_chunk_slopes``): ``exp2(-(8 / nq) * (h + 1))`` in f32,
    ``alibi_slopes`` for a power-of-two ``nq`` up to rounding."""
    h = torch.arange(nq, dtype=torch.float32, device=device)
    return torch.exp2(-(8.0 / nq) * (h + 1.0))


def rope_rows(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF rotate-half rope of ``x [..., hd]`` in f32."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def qdot_layer(ql: QLinear, l: Optional[int], x: torch.Tensor) -> torch.Tensor:
    """:func:`qdot_plain` of layer ``l`` of a stacked QLinear (``l=None``:
    a 2-D one, the head)."""
    if l is None:
        return qdot_plain(x, ql.qweight, ql.scales, ql.szeros, ql.dense3)
    return qdot_plain(x, ql.qweight[l], ql.scales[l], ql.szeros[l], ql.dense3)



def attn_plain(h, wqkv, ln1, cos_row, sin_row, cache, l, length, nq, nkv, eps,
               scales=None, shape="llama"):
    """The attention of one layer on the f32 residual ``h [1, H]``: RMSNorm,
    QKV (+ bias), rope, attention over the cache prefix and the current
    token (the MPT shape: LayerNorm, no rope, the ALiBi bias ``slope * t``
    on the score of position ``t``). Writes the cache (codes and ``scales``
    for an int8 one) at ``length`` and returns ``(attn f32 [1, nq*hd], k, v
    f32 [nkv, hd])``."""
    hd = HEAD_DIM
    grp = nq // nkv
    x = norm_rows(h, ln1[l], eps, shape)
    qkv = qdot_layer(wqkv, l, x)[0]
    if wqkv.bias is not None:
        qkv = qkv + wqkv.bias[l].float()
    q = qkv[:nq * hd].reshape(nq, hd)
    k = qkv[nq * hd:(nq + nkv) * hd].reshape(nkv, hd)
    if shape != "mpt":
        cos, sin = cos_row.float(), sin_row.float()
        q, k = rope_rows(q, cos, sin), rope_rows(k, cos, sin)
    v = qkv[(nq + nkv) * hd:].reshape(nkv, hd)
    qs = (q * (1.0 / math.sqrt(hd))).reshape(nkv, grp, hd)
    if scales is None:
        prefix = cache[l, :, 0, :, :length].float()
    else:
        prefix = dequantize_kv(cache[l, :, 0, :, :length], scales[l, :, 0, :, :length])
    keys = torch.cat([prefix[0], k[:, None]], dim=1)
    vals = torch.cat([prefix[1], v[:, None]], dim=1)
    sc = torch.einsum("kgh,kth->kgt", qs, keys)
    if shape == "mpt":
        pos = torch.arange(length + 1, dtype=torch.float32, device=h.device)
        sc = sc + mpt_slopes(nq, h.device).reshape(nkv, grp, 1) * pos
    p = torch.softmax(sc, dim=-1)
    attn = torch.einsum("kgt,kth->kgh", p, vals).reshape(1, nq * hd)
    write_kv(cache, scales, (l, slice(None), 0, slice(None), length), torch.stack([k, v]))
    return attn, k, v


def mlp_plain(h1, wgu, wdn, ln2, l, eps, shape="llama"):
    """The MLP of one layer on the f32 residual ``h1 [1, H]``: RMSNorm,
    gate/up, SiLU·mul, down (the MPT shape: LayerNorm, up, the erf GELU,
    down); returns down's output, f32 ``[1, H]``, without the residual."""
    gu = qdot_layer(wgu, l, norm_rows(h1, ln2[l], eps, shape))
    if shape == "mpt":
        hm = torch.nn.functional.gelu(gu)
    else:
        gate, up = gu.chunk(2, dim=-1)
        hm = gate * torch.sigmoid(gate) * up
    return qdot_layer(wdn, l, hm)


def _layer_plain(h, wqkv, wo, wgu, wdn, ln1, ln2, cos_row, sin_row, cache,
                 l, length, nq, nkv, eps, scales=None, shape="llama"):
    """One layer on the f32 residual ``h [1, H]``; writes the cache (codes
    and ``scales`` for an int8 one) at ``length`` and returns ``(h_new f32
    [1, H], k, v f32 [nkv, hd])``."""
    attn, k, v = attn_plain(h, wqkv, ln1, cos_row, sin_row, cache, l, length, nq, nkv,
                            eps, scales, shape)
    h1 = h + qdot_layer(wo, l, attn)
    return h1 + mlp_plain(h1, wgu, wdn, ln2, l, eps, shape), k, v


def write_kv(cache, scales, at, kv):
    """``cache[at] = kv`` in the cache dtype; for an int8 cache the codes and
    ``scales[at]`` of :func:`quantize_kv` of ``bf16(kv)``, as JAX's caller
    quantizes the megakernels' bf16 k/v. ``at`` indexes the position of
    every (k|v, head) row of ``kv [2, ..., hd]``."""
    if scales is None:
        cache[at] = kv.to(cache.dtype)
    else:
        cache[at], scales[at] = quantize_kv(kv.to(torch.bfloat16))


def w4a16_llama_layer_step_plain(h, wqkv, wo, wgu, wdn, ln1, ln2, cos_row,
                                 sin_row, cache, layer_idx, length, nq, nkv,
                                 eps=1e-5, cache_scales=None, shape="llama"):
    """Plain version of K4's layer entry: ``(h_new [1, H] in h.dtype,
    k_new, v_new [1, nkv, hd] in the cache dtype, bf16 for int8)``; writes
    the cache."""
    hn, k, v = _layer_plain(h.float(), wqkv, wo, wgu, wdn, ln1, ln2,
                            cos_row, sin_row, cache, int(layer_idx),
                            int(length), nq, nkv, eps, cache_scales, shape)
    kt = kv_out_dtype(cache)
    return (hn.to(h.dtype), k[None].to(kt), v[None].to(kt))


def w4a16_llama_token_step_plain(h, wqkv, wo, wgu, wdn, ln1, ln2, cos_row,
                                 sin_row, cache, length, nq, nkv, eps=1e-5,
                                 whead: Optional[QLinear] = None,
                                 norm_w: Optional[torch.Tensor] = None,
                                 cache_scales=None, shape="llama"):
    """Plain version of K4's token entry: ``(h_new [1, H], k_new, v_new
    [L, nkv, hd])`` plus ``logits [1, V]`` f32 with a head; writes the
    cache at ``length`` in every layer."""
    hh = h.float()
    ks, vs = [], []
    for l in range(cache.shape[0]):
        hn, k, v = _layer_plain(hh, wqkv, wo, wgu, wdn, ln1, ln2, cos_row,
                                sin_row, cache, l, int(length), nq, nkv, eps,
                                cache_scales, shape)
        hh = hn.to(torch.bfloat16).float()   # bf16 between layers
        ks.append(k)
        vs.append(v)
    kt = kv_out_dtype(cache)
    out = (hh.to(h.dtype), torch.stack(ks).to(kt), torch.stack(vs).to(kt))
    if whead is None:
        return out
    xf = norm_rows(hh, norm_w, eps, shape)
    return out + (qdot_layer(whead, None, xf),)


# ---- the wrappers ----------------------------------------------------------------

def _fail(what: str, msg: str):
    raise ValueError(f"{what}: {msg}")


def check_operands(what, h, lins, ln1, ln2, cache, nq, nkv, rows, slots=1,
                   scales=None, gated=True):
    """Shared checks of K4, K5 and K6: what the kernels take. An int8 cache
    comes with its f32 ``scales [L, 2, slots, nkv, T]``. ``gated``: the MLP's
    first linear is gate/up ``[.., 2I]`` (else K4's MPT ``up``, ``[.., I]``).
    Returns ``(L, H, I, w3)``, ``w3`` the linears' format (all W3 in
    ``pack_int3``, or all W4)."""
    if cache.dtype == torch.int8:
        if scales is None:
            _fail(what, "an int8 cache needs its scales (cache_scales)")
        if tuple(scales.shape) != tuple(cache.shape[:5]) or scales.dtype != torch.float32:
            _fail(what, f"cache_scales must be f32 {list(cache.shape[:5])}, got "
                  f"{scales.dtype} {list(scales.shape)}")
        check_small(what, cache.device, torch.float32, cache_scales=scales)
    elif cache.dtype not in CACHE_DTYPES:
        _fail(what, f"cache dtype {cache.dtype}: the kernels take f32, bf16, f16 "
              "or int8 with scales")
    elif scales is not None:
        _fail(what, f"cache_scales with a {cache.dtype} cache")
    L, hd = cache.shape[0], cache.shape[-1]
    H = h.shape[-1]
    if hd != HEAD_DIM or cache.dim() != 6 or cache.shape[2] != slots \
            or cache.shape[3] != nkv:
        _fail(what, f"cache must be [L, 2, {slots}, {nkv}, T, {HEAD_DIM}], got "
              f"{tuple(cache.shape)}")
    if nq % nkv or nq * hd != H or H % GROUP:
        _fail(what, f"nq={nq}, nkv={nkv} do not fit H={H}")
    if h.dtype not in _DTYPE_CODE or tuple(h.shape) != (rows, H):
        _fail(what, f"h must be float [{rows}, {H}], got {h.dtype} "
              f"{tuple(h.shape)}")
    wqkv, wo, wgu, wdn = lins
    inter = wgu.out_features // 2 if gated else wgu.out_features
    w3 = weight_format(wqkv)
    if w3 is None:
        _fail(what, f"wqkv must be W4 or W3 in pack_int3 (dense3), g{GROUP}; got "
              f"w_bit={wqkv.w_bit}, dense3={wqkv.dense3}, g{wqkv.group_size}")
    fmt = "W3 (dense3)" if w3 else "W4"
    shapes = {"wqkv": (wqkv, H, (nq + 2 * nkv) * hd), "wo": (wo, H, H),
              ("wgateup" if gated else "up"): (wgu, H, (2 if gated else 1) * inter),
              "down": (wdn, inter, H)}
    for name, (p, ic, oc) in shapes.items():
        rows = ic * 3 // 32 if w3 else ic // 8
        if weight_format(p) != w3 or tuple(p.qweight.shape) != (L, rows, oc):
            _fail(what, f"{name} must be {fmt} g{GROUP} [{L}, {rows}, {oc}], as wqkv")
        if p.bias is not None and name != "wqkv":
            _fail(what, f"{name} has a bias; only wqkv may")
        if oc % 32 or inter % GROUP:
            _fail(what, f"{name}: OC={oc} must be a multiple of 32")
    for t in (ln1, ln2):
        if tuple(t.shape) != (L, H) or t.dtype != h.dtype:
            _fail(what, f"norm weights must be {h.dtype} [{L}, {H}]")
    return L, H, inter, w3


def qlinear_ptrs(p: QLinear, dev):
    for t in (p.qweight, p.scales, p.szeros):
        if t.device != dev or not t.is_contiguous():
            _fail("megakernel", "weights must be contiguous on the cache's device")
    if p.qweight.dtype != torch.int32 or p.scales.dtype != torch.float32 \
            or p.szeros.dtype != torch.float32:
        _fail("megakernel", "codes must be int32 and scales/szeros float32")
    return [p.qweight.data_ptr(), p.scales.data_ptr(), p.szeros.data_ptr()]


def check_small(what, dev, dtype, **tensors):
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != dev or not t.is_contiguous():
            _fail(what, f"{name} must be contiguous on {dev}")
        if dtype is not None and t.dtype != dtype:
            _fail(what, f"{name} must be {dtype}, got {t.dtype}")


def head_operands(what, whead, norm_w, H, rows, dev, w3=False):
    """``(vocab, [head pointers, norm pointer], logits [rows, V] f32)`` of a
    megakernel's optional last phase, the final norm and the head in the
    body's format (``w3``); ``(0, four null pointers, None)`` without a
    head."""
    if whead is None:
        return 0, [0, 0, 0, 0], None
    if (not head_in_kernel({"lm_head": whead}) or weight_format(whead) != w3
            or whead.in_features != H):
        _fail(what, f"the head must be a 2-D {'W3 (dense3)' if w3 else 'W4'} g128 "
              "QLinear over H without bias, V a multiple of 32, in the body's format")
    logits = torch.empty((rows, whead.out_features), dtype=torch.float32, device=dev)
    return (whead.out_features, qlinear_ptrs(whead, dev) + [norm_w.data_ptr()],
            logits)


def launch(entry: str, what: str, ptrs, ints, eps: float, dev) -> None:
    """Call a megakernel C entry: ``entry(ptrs, ints, eps, ws, stream)``.
    The workspace it needs comes from ``<entry>_ws`` (same arguments)."""
    from awq_tpu_torch import _build

    lib = _build.load(what)
    P = ctypes.c_void_p * len(ptrs)
    N = ctypes.c_int * len(ints)
    cptrs, cints = P(*ptrs), N(*ints)
    wsf = getattr(lib, entry + "_ws")
    _build.declare(wsf, _build.P, _build.P)
    wsf.restype = ctypes.c_longlong
    n = wsf(ctypes.cast(cptrs, ctypes.c_void_p), ctypes.cast(cints, ctypes.c_void_p))
    if n < 0:
        _build.check(lib, int(-n), what)
    ws = torch.empty((max(int(n), 1),), dtype=torch.float32, device=dev)
    fn = getattr(lib, entry)
    _build.declare(fn, _build.P, _build.P, _build.F, _build.P, _build.P)
    err = fn(ctypes.cast(cptrs, ctypes.c_void_p), ctypes.cast(cints, ctypes.c_void_p),
             eps, ws.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, what)


def _token_launch(what, counter, h, wqkv, wo, wgu, wdn, ln1, ln2, cos_row,
                  sin_row, cache, layer0, n_layers, length, nq, nkv, eps,
                  whead=None, norm_w=None, round_residual=True, scales=None,
                  max_length=None, shape="llama"):
    dev = cache.device
    if not cache.is_cuda:
        _fail(what, f"unsupported device {dev}")
    if shape not in SHAPES:
        _fail(what, f"shape {shape!r}: K4 is built for {SHAPES}")
    mpt = shape == "mpt"
    if mpt and (scales is not None or nq & (nq - 1)):
        _fail(what, "the MPT shape takes a float cache and a power-of-two head count")
    L, H, inter, w3 = check_operands(what, h, (wqkv, wo, wgu, wdn), ln1, ln2,
                                     cache, nq, nkv, 1, scales=scales, gated=not mpt)
    T = cache.shape[4]
    pos = None
    if isinstance(length, torch.Tensor):
        # the position lives in device memory: the kernel reads it there,
        # gathers its rope rows from the tables and plans its attention
        # split from it; max_length, the host's bound on it, sizes the
        # workspace
        pos = length
        check_small(what, dev, torch.int32, length=pos)
        if pos.numel() != 1:
            _fail(what, f"a device length holds one int32, got {pos.numel()}")
        if max_length is None or not 0 <= int(max_length) < T:
            _fail(what, f"a device length needs max_length in [0, {T}), got {max_length}")
        if not mpt and (cos_row.dim() != 2 or cos_row.shape[1] != HEAD_DIM
                        or cos_row.shape[0] <= max_length or sin_row.shape != cos_row.shape):
            _fail(what, f"with a device length cos/sin are the rope tables [> {max_length}, "
                  f"{HEAD_DIM}], got {tuple(cos_row.shape)}")
        length, plan = 0, int(max_length)
    else:
        length = int(length)
        plan = length if max_length is None else int(max_length)
        if not 0 <= length <= plan < T:
            _fail(what, f"length {length} and max_length {plan} must satisfy "
                  f"0 <= length <= max_length < {T}")
        if not mpt and (cos_row.numel() != HEAD_DIM or sin_row.numel() != HEAD_DIM):
            _fail(what, f"cos/sin rows must hold {HEAD_DIM} values")
    if mpt:
        cos_row = sin_row = None       # no rope: the kernel reads no table
    if layer0 < 0 or layer0 + n_layers > L:
        _fail(what, f"layers [{layer0}, {layer0 + n_layers}) outside [0, {L})")
    check_small(what, dev, None, h=h, ln1=ln1, ln2=ln2, cache=cache)
    check_small(what, dev, torch.float32, cos_row=cos_row, sin_row=sin_row)
    bias = wqkv.bias
    check_small(what, dev, h.dtype, bias=bias, norm_w=norm_w)
    vocab, head, logits = head_operands(what, whead, norm_w, H, 1, dev, w3)
    out = torch.empty_like(h)
    k_new = torch.empty((n_layers, nkv, HEAD_DIM), dtype=kv_out_dtype(cache), device=dev)
    v_new = torch.empty_like(k_new)
    ptrs = (
        [h.data_ptr(), out.data_ptr()]
        + qlinear_ptrs(wqkv, dev) + [bias.data_ptr() if bias is not None else 0]
        + qlinear_ptrs(wo, dev) + qlinear_ptrs(wgu, dev) + qlinear_ptrs(wdn, dev)
        + [ln1.data_ptr(), ln2.data_ptr(), 0 if mpt else cos_row.data_ptr(),
           0 if mpt else sin_row.data_ptr(), cache.data_ptr(), k_new.data_ptr(),
           v_new.data_ptr()]
        + head + [logits.data_ptr() if logits is not None else 0,
                  scales.data_ptr() if scales is not None else 0,
                  pos.data_ptr() if pos is not None else 0])
    ints = [layer0, n_layers, L, H, inter, nq, nkv, T, length, vocab,
            int(round_residual), _DTYPE_CODE[h.dtype], _CACHE_CODE[cache.dtype],
            int(bias is not None), int(w3), MODE_LAYERS, plan]
    unit = "megakernel" + ("_mpt" if mpt else "") + ("_w3" if w3 else "")
    launch("awq_mega_token", unit, ptrs, ints, eps, dev)
    LAUNCHES[counter + ("_mpt" if mpt else "") + ("_w3" if w3 else "")
             + ("_int8" if scales is not None else "")] += 1
    res = (out, k_new, v_new)
    return res + ((logits,) if logits is not None else ())


def w4a16_llama_layer_step(h, wqkv, wo, wgu, wdn, ln1, ln2, cos_row, sin_row,
                           cache, layer_idx, length, nq, nkv, eps=1e-5,
                           cache_scales=None, shape="llama"):
    """One decoder layer for one token (K4 over ``[l, l+1)``).

    ``h [1, H]`` residual, the four stacked W4 linears, ``ln1``/``ln2
    [L, H]``, the rope rows ``[hd]`` f32 at position ``length``, ``cache
    [L, 2, 1, nkv, T, hd]`` (written at ``length`` of layer ``l``; int8
    with ``cache_scales [L, 2, 1, nkv, T]`` f32). ``shape="mpt"``: K4's MPT
    shape (``wgu`` the ``up`` stack; the rope rows are not read and may be
    None). Returns ``(h_new [1, H], k_new [1, nkv, hd], v_new)``."""
    if cache.device.type == "cpu":
        return w4a16_llama_layer_step_plain(h, wqkv, wo, wgu, wdn, ln1, ln2,
                                            cos_row, sin_row, cache, layer_idx,
                                            length, nq, nkv, eps, cache_scales, shape)
    return _token_launch("megakernel_layer", "megakernel_layer", h, wqkv, wo,
                         wgu, wdn, ln1, ln2, cos_row, sin_row, cache,
                         int(layer_idx), 1, int(length), nq, nkv, eps,
                         round_residual=False, scales=cache_scales, shape=shape)


def w4a16_llama_token_step(h, wqkv, wo, wgu, wdn, ln1, ln2, cos_row, sin_row,
                           cache, length, nq, nkv, eps=1e-5,
                           whead: Optional[QLinear] = None,
                           norm_w: Optional[torch.Tensor] = None,
                           cache_scales=None, max_length: Optional[int] = None,
                           shape: str = "llama"):
    """All decoder layers for one token in one launch of K4; with
    ``whead``/``norm_w`` also the final RMSNorm and the W4 head. Returns
    ``(h_new [1, H], k_new [L, nkv, hd], v_new)`` (+ ``logits [1, V]``
    f32); the cache is written at ``length`` in every layer (int8 codes and
    ``cache_scales`` for an int8 cache, whose k/v come back bf16).

    ``length`` is a host int, with ``cos_row``/``sin_row`` the rope rows
    ``[hd]`` at it, or an int32 tensor ``[1]`` on the cache's device, with
    ``cos_row``/``sin_row`` the rope tables ``[T', hd]``: the kernel then
    reads the position and its rope rows from device memory, so that a
    captured decode step replays at every position. ``max_length`` (at
    least the length; required with a device length) bounds the position
    and sizes the workspace; the kernel splits its attention by the length
    it reads, so a device length gives the bits of the same length passed
    as a host int, whatever ``max_length``. ``shape="mpt"``: K4's MPT shape
    (``wgu`` the ``up`` stack, the final norm a LayerNorm; the rope rows or
    tables are not read and may be None)."""
    if cache.device.type == "cpu":
        if isinstance(length, torch.Tensor):
            length = int(length.reshape(-1)[0])
            if cos_row is not None:
                cos_row, sin_row = cos_row[length], sin_row[length]
        return w4a16_llama_token_step_plain(h, wqkv, wo, wgu, wdn, ln1, ln2,
                                            cos_row, sin_row, cache, length,
                                            nq, nkv, eps, whead, norm_w,
                                            cache_scales, shape)
    return _token_launch("megakernel_token", "megakernel_token", h, wqkv, wo,
                         wgu, wdn, ln1, ln2, cos_row, sin_row, cache, 0,
                         cache.shape[0], length, nq, nkv, eps,
                         whead=whead, norm_w=norm_w, scales=cache_scales,
                         max_length=max_length, shape=shape)
