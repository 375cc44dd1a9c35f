"""Tensor-parallel decode half-layer megakernels (PyTorch port of
``awq_tpu/ops/megakernel_tp.py``).

The whole-token megakernel K4 fuses every layer into one launch, so no
all-reduce fits between its layers. Under tensor parallelism one decoder
layer is split at its two collective points instead, each half one
launch on the rank's shards of the deploy layout (``parallel/deploy.py``):

- :func:`w4a16_llama_attn_half` (K12, Pallas row 19): RMSNorm -> the
  rank's fused QKV (+ bias) -> rope -> attention over the rank's kv heads of
  the cache prefix plus the current token -> o-proj over the rank's input
  channels -> an f32 ``[1, H]`` PARTIAL sum, without the residual. The new
  k/v are written into the rank's cache in place (the bf16 k/v, or their
  ``quantize_kv`` for an int8 cache) and returned, as K4 does.
- :func:`w4a16_llama_mlp_half` (K13, Pallas row 20): RMSNorm of the f32
  residual -> the rank's gate/up -> SiLU·mul -> down over the rank's input
  channels -> an f32 ``[1, H]`` partial sum.

``models/llama.py::forward`` runs, per layer, K12 -> all-reduce -> residual
-> K13 -> all-reduce -> residual: two launches and two collectives per
layer. Both kernels are instances of K4's body (``csrc/megakernel.cu``,
modes ``MODE_ATT`` and ``MODE_MLP``), as the JAX kernels are built from
K4's ``_attn_phases`` and ``_mlp_phases``, so each comes in K4's weight
formats (W4, W3 in ``pack_int3``) and its cache instances (bf16, f16, f32,
int8 with scales), with K4's arithmetic and rounding points.

Each has a plain PyTorch version (``*_plain``): the CPU path and the
reference the kernel is held to on the card. The wrappers run the plain
version for CPU tensors and launch the kernel for CUDA tensors, or raise.
"""

from __future__ import annotations

import torch

from awq_tpu_torch.ops import megakernel as mk
from awq_tpu_torch.ops.w4a16 import QLinear

#: Launches of K12 (over a float cache and over an int8 one) and K13, in W4
#: and in W3 mode, counted where the wrappers launch them.
LAUNCHES = {**{f"megakernel_attn_half{w}{c}": 0 for w in ("", "_w3") for c in ("", "_int8")},
            **{f"megakernel_mlp_half{w}": 0 for w in ("", "_w3")}}


def tp_megakernel_supported(cfg, layers, cache) -> bool:
    """Whether a rank's one-token decode takes K12 and K13. ``cfg`` is the
    rank's local view (``tp_local_cfg``), ``layers``/``cache`` the rank's
    shards. JAX's gate (``awq_tpu/ops/megakernel_tp.py:297-330``) without
    its Mosaic-only parts (the tiled/folded layout, ``T % 256`` and the
    VMEM budget), as :func:`~awq_tpu_torch.ops.megakernel.
    megakernel_supported` drops them, plus K4's own limits (at most 8 q
    heads per kv head): the llama shape at head_dim 128, the four fused
    stacked g128 linears all W4 or all W3 in ``pack_int3``, a bias on
    ``wqkv`` only, a bf16/f16/f32 cache or an int8 one with its scales, of
    batch 1 and the rank's kv heads, ``H`` and the rank's intermediate size
    multiples of 128, and no ``act_scale``. The device and the environment
    switches are ``forward``'s conditions."""
    if cfg.head_dim != mk.HEAD_DIM or cfg.act != "silu" or cfg.norm != "rmsnorm":
        return False
    if cfg.parallel_block or cfg.rotary_pct != 1.0:
        return False
    if cfg.num_heads % cfg.num_kv_heads or cfg.num_heads // cfg.num_kv_heads > mk.MAX_GROUP:
        return False
    needed = ("wqkv", "wgateup", "wo", "down")
    if not all(n in layers for n in needed):
        return False
    fmt = mk.weight_format(layers["wqkv"])
    for n in needed:
        p = layers[n]
        if not isinstance(p, QLinear) or p.qweight.dim() != 3:
            return False
        if p.bias is not None and n != "wqkv":   # qwen2: the QKV bias only
            return False
        if fmt is None or mk.weight_format(p) != fmt:
            return False
    data, scales = mk.split_cache(cache)
    if not isinstance(data, torch.Tensor) or data.dim() != 6:
        return False
    if scales is None and data.dtype not in mk.CACHE_DTYPES:
        return False
    if scales is not None and (data.dtype != torch.int8
                               or tuple(scales.shape) != tuple(data.shape[:5])):
        return False
    if data.shape[2] != 1 or data.shape[3] != cfg.num_kv_heads:
        return False
    if layers["wqkv"].in_features % mk.GROUP or layers["down"].in_features % mk.GROUP:
        return False
    return layers.get("act_scale") is None


# ---- plain versions ------------------------------------------------------------

def w4a16_llama_attn_half_plain(h, wqkv, wo, ln1, cos_row, sin_row, cache, layer_idx,
                                length, nq, nkv, eps=1e-5, cache_scales=None):
    """Plain version of K12: ``(o_part f32 [1, H], k_new, v_new [nkv, hd]
    in the cache dtype, bf16 for int8)``; writes the cache at ``length`` of
    layer ``layer_idx``."""
    l = int(layer_idx)
    attn, k, v = mk.attn_plain(h.float(), wqkv, ln1, cos_row, sin_row, cache, l,
                               int(length), nq, nkv, eps, cache_scales)
    kt = mk.kv_out_dtype(cache)
    return mk.qdot_layer(wo, l, attn), k.to(kt), v.to(kt)


def w4a16_llama_mlp_half_plain(h1, wgu, wdn, ln2, layer_idx, eps=1e-5):
    """Plain version of K13: down's f32 ``[1, H]`` partial of layer
    ``layer_idx`` from the f32 residual ``h1 [1, H]``."""
    return mk.mlp_plain(h1.float(), wgu, wdn, ln2, int(layer_idx), eps)


# ---- the wrappers ----------------------------------------------------------------

def _check_lin(what, name, p, L, ic, oc, w3):
    rows = ic * 3 // 32 if w3 else ic // 8
    if mk.weight_format(p) != w3 or tuple(p.qweight.shape) != (L, rows, oc):
        mk._fail(what, f"{name} must be {'W3 (dense3)' if w3 else 'W4'} g{mk.GROUP} "
                 f"[{L}, {rows}, {oc}], got {tuple(p.qweight.shape)}")
    if ic % (2 * mk.GROUP if w3 else mk.GROUP) or oc % 32:
        mk._fail(what, f"{name}: IC={ic} must be a multiple of {2 * mk.GROUP if w3 else mk.GROUP}"
                 f" and OC={oc} of 32")


def _check_layer(what, layer_idx, L):
    if not 0 <= layer_idx < L:
        mk._fail(what, f"layer {layer_idx} outside [0, {L})")


def _format(what, p):
    w3 = mk.weight_format(p)
    if w3 is None:
        mk._fail(what, f"the linears must be W4 or W3 in pack_int3 (dense3), g{mk.GROUP}")
    return w3


def w4a16_llama_attn_half(h, wqkv, wo, ln1, cos_row, sin_row, cache, layer_idx, length,
                          nq, nkv, eps=1e-5, cache_scales=None):
    """The attention half of one decoder layer for one token on one rank
    (K12). ``h [1, H]`` the residual (replicated), ``wqkv`` the rank's fused
    q|k|v columns ``[L, ., (nq + 2 nkv) hd]``, ``wo`` its input-channel rows
    ``[L, ., H]``, ``ln1 [L, H]``, the rope rows ``[hd]`` f32 at ``length``,
    the rank's ``cache [L, 2, 1, nkv, T, hd]`` (int8 with ``cache_scales``);
    ``nq``/``nkv`` the rank's heads. Returns ``(o_part f32 [1, H], k_new,
    v_new [nkv, hd])`` and writes the cache at ``length`` of layer
    ``layer_idx``."""
    if cache.device.type == "cpu":
        return w4a16_llama_attn_half_plain(h, wqkv, wo, ln1, cos_row, sin_row, cache,
                                           layer_idx, length, nq, nkv, eps, cache_scales)
    what, dev = "megakernel_attn_half", cache.device
    if not cache.is_cuda:
        mk._fail(what, f"unsupported device {dev}")
    layer_idx, length = int(layer_idx), int(length)
    L, T, H = cache.shape[0], cache.shape[4], h.shape[-1]
    hd = mk.HEAD_DIM
    if cache.dtype == torch.int8:
        if cache_scales is None or tuple(cache_scales.shape) != tuple(cache.shape[:5]):
            mk._fail(what, "an int8 cache needs its f32 scales [L, 2, 1, nkv, T]")
        mk.check_small(what, dev, torch.float32, cache_scales=cache_scales)
    elif cache.dtype not in mk.CACHE_DTYPES or cache_scales is not None:
        mk._fail(what, f"cache dtype {cache.dtype}: f32, bf16, f16, or int8 with scales")
    if cache.dim() != 6 or cache.shape[2] != 1 or cache.shape[3] != nkv or cache.shape[5] != hd:
        mk._fail(what, f"cache must be [L, 2, 1, {nkv}, T, {hd}], got {tuple(cache.shape)}")
    if nq % nkv or nq // nkv > mk.MAX_GROUP or H % mk.GROUP:
        mk._fail(what, f"nq={nq}, nkv={nkv}, H={H}: at most {mk.MAX_GROUP} q heads per kv "
                 f"head, H a multiple of {mk.GROUP}")
    if h.dtype not in mk._DTYPE_CODE or tuple(h.shape) != (1, H):
        mk._fail(what, f"h must be float [1, {H}], got {h.dtype} {tuple(h.shape)}")
    w3 = _format(what, wqkv)
    _check_lin(what, "wqkv", wqkv, L, H, (nq + 2 * nkv) * hd, w3)
    _check_lin(what, "wo", wo, L, nq * hd, H, w3)
    if wo.bias is not None:
        mk._fail(what, "wo has a bias; the caller adds it after the all-reduce")
    _check_layer(what, layer_idx, L)
    if not 0 <= length < T:
        mk._fail(what, f"length {length} must lie in [0, {T})")
    if tuple(ln1.shape) != (L, H) or ln1.dtype != h.dtype:
        mk._fail(what, f"ln1 must be {h.dtype} [{L}, {H}]")
    mk.check_small(what, dev, None, h=h, ln1=ln1, cache=cache)
    mk.check_small(what, dev, torch.float32, cos_row=cos_row, sin_row=sin_row)
    if cos_row.numel() != hd or sin_row.numel() != hd:
        mk._fail(what, f"cos/sin rows must hold {hd} values")
    bias = wqkv.bias
    mk.check_small(what, dev, h.dtype, bias=bias)
    part = torch.empty((1, H), dtype=torch.float32, device=dev)
    k_new = torch.empty((nkv, hd), dtype=mk.kv_out_dtype(cache), device=dev)
    v_new = torch.empty_like(k_new)
    ptrs = ([h.data_ptr(), part.data_ptr()]
            + mk.qlinear_ptrs(wqkv, dev) + [bias.data_ptr() if bias is not None else 0]
            + mk.qlinear_ptrs(wo, dev) + [0] * 6
            + [ln1.data_ptr(), 0, cos_row.data_ptr(), sin_row.data_ptr(),
               cache.data_ptr(), k_new.data_ptr(), v_new.data_ptr()]
            + [0] * 5 + [cache_scales.data_ptr() if cache_scales is not None else 0, 0])
    ints = [layer_idx, 1, L, H, 0, nq, nkv, T, length, 0, 0, mk._DTYPE_CODE[h.dtype],
            mk._CACHE_CODE[cache.dtype], int(bias is not None), int(w3), mk.MODE_ATT, length]
    mk.launch("awq_mega_token", "megakernel_w3" if w3 else "megakernel", ptrs, ints, eps, dev)
    LAUNCHES["megakernel_attn_half" + ("_w3" if w3 else "")
             + ("_int8" if cache_scales is not None else "")] += 1
    return part, k_new, v_new


def w4a16_llama_mlp_half(h1, wgu, wdn, ln2, layer_idx, eps=1e-5):
    """The MLP half of one decoder layer on one rank (K13): ``h1 [1, H]``
    the f32 residual after the attention (replicated), ``wgu`` the rank's
    gate|up columns ``[L, ., 2 I]`` (gate column ``j`` and up column ``I +
    j`` of the rank's ``I``), ``wdn`` its input-channel rows ``[L, ., H]``,
    ``ln2 [L, H]`` in the model dtype. Returns down's f32 ``[1, H]``
    partial sum of layer ``layer_idx``."""
    if h1.device.type == "cpu":
        return w4a16_llama_mlp_half_plain(h1, wgu, wdn, ln2, layer_idx, eps)
    what, dev = "megakernel_mlp_half", h1.device
    if not h1.is_cuda:
        mk._fail(what, f"unsupported device {dev}")
    layer_idx = int(layer_idx)
    H = h1.shape[-1]
    if h1.dtype != torch.float32 or tuple(h1.shape) != (1, H) or H % mk.GROUP:
        mk._fail(what, f"h1 must be f32 [1, H] with H a multiple of {mk.GROUP}, got "
                 f"{h1.dtype} {tuple(h1.shape)}")
    w3 = _format(what, wgu)
    L, inter = wgu.qweight.shape[0], wgu.out_features // 2
    _check_lin(what, "wgateup", wgu, L, H, 2 * inter, w3)
    _check_lin(what, "down", wdn, L, inter, H, w3)
    if wgu.bias is not None or wdn.bias is not None:
        mk._fail(what, "gate/up and down take no bias")
    if inter % mk.GROUP:
        mk._fail(what, f"the intermediate size {inter} must be a multiple of {mk.GROUP}")
    _check_layer(what, layer_idx, L)
    if tuple(ln2.shape) != (L, H) or ln2.dtype not in mk._DTYPE_CODE:
        mk._fail(what, f"ln2 must be float [{L}, {H}]")
    mk.check_small(what, dev, None, h1=h1, ln2=ln2)
    part = torch.empty((1, H), dtype=torch.float32, device=dev)
    ptrs = ([h1.data_ptr(), part.data_ptr()] + [0] * 7
            + mk.qlinear_ptrs(wgu, dev) + mk.qlinear_ptrs(wdn, dev)
            + [0, ln2.data_ptr()] + [0] * 12)
    ints = [layer_idx, 1, L, H, inter, 1, 1, 0, 0, 0, 0, mk._DTYPE_CODE[ln2.dtype],
            mk._CACHE_CODE[torch.bfloat16], 0, int(w3), mk.MODE_MLP, 0]
    mk.launch("awq_mega_token", "megakernel_w3" if w3 else "megakernel", ptrs, ints, eps, dev)
    LAUNCHES["megakernel_mlp_half" + ("_w3" if w3 else "")] += 1
    return part
