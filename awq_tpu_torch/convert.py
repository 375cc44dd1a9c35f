"""Carry a JAX parameter tree of ``awq_tpu`` across to the port, bit for bit.

:func:`params_from_jax` takes the tree after ``jax.device_get`` (every leaf
a numpy array) and reads its ``QLinear`` and ``Linear`` leaves by
attribute, so this module imports nothing of the JAX package. It accepts
the unfused tree of ``quantize_params`` and the trees of ``fuse_linears``
with or without ``tile``.

The TPU's tiled and folded layouts (``tile_qlinear``) are unfolded back
into ``pack_int4``'s plain ``[(L,) IC//8, OC]``, the only layout the port's
kernels read:

- tiled: block-contiguous ``[(L,) NB, rows, bn]``; un-blockified;
- folded: besides the tiling, the code words hold the bf16-bitpack nibble
  order, and each block carries one packed qparam row per group (bf16
  scale in the low half-word, bf16 szero in the high) after its ``IC//8``
  code rows, then a pad to 8 rows. The nibbles are put back in the
  standard order, and ``scales``/``szeros`` are read from the qparam rows
  and widened to f32: the values the folded kernels compute with, present
  even where ``strip_unfolded_qparams`` dropped the f32 fields.

The dense 3-bit layout (``dense3``, ``pack_int3`` ``[(L,) IC*3//32, OC]``)
is copied as it is. Its TPU fold, ``w3x`` (``tile_qlinear(...,
fold_scales=True)`` of a dense3 QLinear), is unfolded back into
``pack_int3``: each full chunk of 5 groups holds 64 rows whose 16-bit
halves carry 5 codes of 3 bits (code ``2r + h`` of group ``5c + j`` in
row ``r``, bits ``16h + 3j``), each of the ``n_groups % 5`` trailer
groups 16 rows of nibbles (code ``32j + 2r + h`` in row ``r``, bits
``16h + 4j``), then the bf16 qparam band as for W4. The group count comes
from the QLinear's ``n_groups``: the row count alone does not give it.
A stacked-of-1 ``lm_head`` (``_tile_head``) comes back 2-D. The OC tails
``<name>_rem`` of a falcon-7b-class tree (``fuse_linears(tile=True)``)
are concatenated back onto ``<name>``. An int8
prefill weight cache (``<name>_w8``, a JAX ``W8Stack`` of ``[L, NB, IC,
bn]`` blocks) comes back in the port's ``[L, OC, IC]`` layout.

:func:`kv_cache8_from_jax` carries a JAX ``KVCache8`` (codes and scales)
across the same way, so that one int8 cache can feed both packages.

:func:`rank_params_from_jax` takes one rank of a JAX ``TPParams`` (the
tensor-parallel deploy layout of ``build_tp_params``, numpy leaves): it
cuts each leaf to the rank's part along the axis its PartitionSpec names
``"tp"`` (:func:`rank_tree_from_jax`; the JAX package assembles its global
arrays so that this part is the rank's own local fold) and converts that
as above, into the port's rank shard
(``awq_tpu_torch.parallel.deploy.build_tp_params``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from awq_tpu_torch import _device
from awq_tpu_torch.models.layers import Linear
from awq_tpu_torch.models.llama import KVCache8
from awq_tpu_torch.ops.w4a16 import QLinear, W8Stack
from awq_tpu_torch.quant.packing import pack_int3


def _tensor(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):      # a record of the port's checkpoint loader
        return a.detach().to(dev, copy=True).contiguous()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, order="C", copy=True)).to(dev)


def _fold_nibble_maps_inv():
    """Standard word ``q`` nibble ``s`` of a 16-word window (true row
    ``r = 64*(q>>3) + 8*s + (q&7)``) lives in folded word ``(r>>1)&15``,
    nibble ``(r>>5) + 4*(r&1)``: ``(src_word, src_shift)`` tables [16, 8]."""
    q = np.arange(16)[:, None]
    s = np.arange(8)[None, :]
    r = 64 * (q >> 3) + 8 * s + (q & 7)
    return (r >> 1) & 15, 4 * ((r >> 5) + 4 * (r & 1))


def _remap_nibbles(qw: np.ndarray, maps) -> np.ndarray:
    """Apply a word/nibble permutation per 16-word window of axis -2."""
    src_word, src_shift = maps
    shape = qw.shape
    w = qw.view(np.uint32).reshape(shape[:-2] + (shape[-2] // 16, 16, shape[-1]))
    out = np.zeros_like(w)
    for k in range(8):
        nib = (np.take(w, src_word[:, k], axis=-2)
               >> src_shift[:, k][:, None].astype(np.uint32)) & np.uint32(0xF)
        out |= nib << np.uint32(4 * k)
    return out.reshape(shape).view(np.int32)


def _untile(a: np.ndarray) -> np.ndarray:
    """``[(L,) NB, rows, bn]`` -> ``[(L,) rows, NB*bn]``."""
    *lead, nb, rows, bn = a.shape
    return np.ascontiguousarray(
        np.swapaxes(a, -3, -2).reshape(*lead, rows, nb * bn))


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def _w3x_codes(w: np.ndarray, n_g: int) -> np.ndarray:
    """The codes ``[(L,) IC, OC]`` of untiled ``w3x`` code rows
    ``[(L,) crows, OC]`` (the inverse of JAX's ``_fold_tile3``)."""
    fc, tg = divmod(n_g, 5)
    *lead, _, oc = w.shape
    w = w.view(np.uint32)
    parts = []
    if fc:
        wf = w[..., :fc * 64, :].reshape(*lead, fc, 1, 64, 1, oc)
        sh = (16 * np.arange(2)[None, :] + 3 * np.arange(5)[:, None]).astype(np.uint32)
        cf = (wf >> sh[:, None, :, None]) & np.uint32(7)       # [.., c, j, r, h, OC]
        parts.append(cf.reshape(*lead, fc * 640, oc))
    if tg:
        wt = w[..., fc * 64:fc * 64 + tg * 16, :].reshape(*lead, tg, 1, 16, 1, oc)
        sh = (16 * np.arange(2)[None, :] + 4 * np.arange(4)[:, None]).astype(np.uint32)
        ct = (wt >> sh[:, None, :, None]) & np.uint32(7)       # [.., t, j, r, h, OC]
        parts.append(ct.reshape(*lead, tg * 128, oc))
    return np.concatenate(parts, axis=-2).astype(np.uint8)


def _pack3(codes: np.ndarray) -> np.ndarray:
    """``pack_int3`` of codes ``[(L,) IC, OC]``."""
    flat = codes.reshape(-1, *codes.shape[-2:])
    packed = [pack_int3(torch.from_numpy(c)).numpy() for c in flat]
    return np.stack(packed).reshape(*codes.shape[:-2], *packed[0].shape)


def _qparams(qp: np.ndarray):
    """f32 ``(scales, szeros)`` of an untiled packed qparam band."""
    qp = qp.view(np.uint32)
    return (_bf16_bits_to_f32(qp & np.uint32(0xFFFF)),
            _bf16_bits_to_f32(qp >> np.uint32(16)))


def unfold_qlinear(x):
    """``(qweight, scales, szeros)`` of a JAX QLinear in the port's plain
    layout, as numpy arrays (an untiled one's scales and szeros as given)."""
    g = int(x.group_size)
    qw = np.asarray(x.qweight)
    if not getattr(x, "tiled_bn", 0):       # the scales as given (bf16 stays bf16)
        return qw, x.scales, x.szeros
    if not getattr(x, "folded", False):
        return _untile(qw), x.scales, x.szeros
    if getattr(x, "dense3", False):
        n_g = int(x.n_groups)
        crows = 64 * (n_g // 5) + 16 * (n_g % 5)
        codes = _w3x_codes(_untile(np.ascontiguousarray(qw[..., :crows, :])), n_g)
        scales, szeros = _qparams(_untile(qw[..., crows:crows + n_g, :]))
        return _pack3(codes), scales, szeros
    rows = qw.shape[-2]
    ic = rows // (g // 8 + 1) * g
    icp, n_g = ic // 8, ic // g
    codes = _remap_nibbles(np.ascontiguousarray(qw[..., :icp, :]),
                           _fold_nibble_maps_inv())
    scales, szeros = _qparams(_untile(qw[..., icp:icp + n_g, :]))
    return _untile(codes), scales, szeros


def _w8stack(x, dev: torch.device) -> W8Stack:
    """A JAX ``W8Stack`` (``w8`` int8 ``[L, NB, IC, bn]``, ``scol`` f32
    ``[L, NB, 1, bn]``) in the port's layout: ``w8 [L, OC, IC]`` with each
    column's codes contiguous, ``scol [L, OC]``."""
    w8, scol = np.asarray(x.w8), np.asarray(x.scol)
    if w8.dtype != np.int8 or w8.ndim != 4 or scol.shape != (*w8.shape[:2], 1, w8.shape[3]):
        raise ValueError(f"a W8Stack holds int8 [L, NB, IC, bn] codes and f32 [L, NB, 1, bn] "
                         f"scales, got {w8.dtype} {w8.shape} and {scol.shape}")
    n_layers, nb, ic, bn = w8.shape
    return W8Stack(w8=_tensor(w8.transpose(0, 1, 3, 2).reshape(n_layers, nb * bn, ic), dev),
                   scol=_tensor(scol.reshape(n_layers, nb * bn), dev))


def _join_tails(layers: dict) -> dict:
    """Each ``<name>_rem`` of JAX's deployed layout (``fuse_linears(tile=True)``
    splits an OC with no 128-wide tile, falcon-7b's, into a tiled main part
    and a plain tail) concatenated back onto ``<name>`` along OC: one
    linear, as the port's kernels read any OC."""
    out = dict(layers)
    for rem_name in [k for k in layers if k.endswith("_rem")]:
        name = rem_name[:-len("_rem")]
        main, rem = out[name], out.pop(rem_name)
        if not (isinstance(main, QLinear) and isinstance(rem, QLinear)
                and (main.w_bit, main.group_size, main.dense3)
                == (rem.w_bit, rem.group_size, rem.dense3)
                and (main.bias is None) == (rem.bias is None)):
            raise ValueError(f"layers/{rem_name}: an OC tail that does not match "
                             f"layers/{name}")
        out[name] = QLinear(
            qweight=torch.cat([main.qweight, rem.qweight], dim=-1),
            scales=torch.cat([main.scales, rem.scales], dim=-1),
            szeros=torch.cat([main.szeros, rem.szeros], dim=-1),
            bias=None if main.bias is None else torch.cat([main.bias, rem.bias], dim=-1),
            w_bit=main.w_bit, group_size=main.group_size, dense3=main.dense3)
    return out


def params_from_jax(tree, device="cuda"):
    """The port's parameter tree from a host copy of a JAX one."""
    dev = _device.resolve(device)

    def conv(x, path):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v, f"{path}/{k}") for k, v in x.items()}
        if hasattr(x, "qweight"):
            dense3 = bool(getattr(x, "dense3", False))
            if x.w_bit not in (3, 4) or (dense3 and x.w_bit != 3):
                raise ValueError(f"{path}: w_bit={x.w_bit}, dense3={dense3}: the "
                                 "packed layouts hold 4-bit or 3-bit codes")
            qw, s, sz = unfold_qlinear(x)
            return QLinear(qweight=_tensor(qw, dev), scales=_tensor(s, dev),
                           szeros=_tensor(sz, dev),
                           bias=conv(x.bias, f"{path}.bias"),
                           w_bit=int(x.w_bit), group_size=int(x.group_size),
                           dense3=dense3)
        if hasattr(x, "w8") and hasattr(x, "scol"):
            return _w8stack(x, dev)
        if hasattr(x, "w"):
            return Linear(w=_tensor(x.w, dev), b=conv(x.b, f"{path}.b"))
        if isinstance(x, (np.ndarray, np.generic)) or hasattr(x, "__array__"):
            return _tensor(x, dev)
        raise TypeError(f"{path}: unsupported leaf {type(x).__name__}")

    out = conv(tree, "params")
    if isinstance(out, dict) and isinstance(out.get("layers"), dict):
        out["layers"] = _join_tails(out["layers"])
    head = out.get("lm_head") if isinstance(out, dict) else None
    if isinstance(head, QLinear) and head.qweight.dim() == 3:
        if head.qweight.shape[0] != 1:
            raise ValueError("lm_head QLinear stacked over more than one layer")
        out["lm_head"] = QLinear(
            qweight=head.qweight[0], scales=head.scales[0],
            szeros=head.szeros[0],
            bias=None if head.bias is None else head.bias[0],
            w_bit=head.w_bit, group_size=head.group_size, dense3=head.dense3)
    return out


def kv_cache8_from_jax(tree, device="cuda") -> KVCache8:
    """The port's :class:`~awq_tpu_torch.models.llama.KVCache8` from a host
    copy of a JAX one (``data`` int8 ``[L, 2, B, n_kv, T, hd]``, ``scales``
    f32 ``[L, 2, B, n_kv, T]``; JAX's ``[.., T//256, 256]`` scale view is
    taken too)."""
    dev = _device.resolve(device)
    data = _tensor(tree.data, dev)
    scales = _tensor(tree.scales, dev)
    if data.dtype != torch.int8 or data.dim() != 6 or scales.dtype != torch.float32:
        raise ValueError(f"a KVCache8 holds int8 [L, 2, B, n_kv, T, hd] codes and f32 "
                         f"scales, got {data.dtype} {tuple(data.shape)} and {scales.dtype}")
    return KVCache8(data=data, scales=scales.reshape(data.shape[:5]).contiguous())


def _rank_part(a, spec, rank: int, tp: int):
    """Rank ``rank``'s part of array ``a`` under a PartitionSpec (a tuple of
    axis names, None or tuples of names; absent trailing axes whole)."""
    if a is None:
        return None
    a = np.asarray(a)
    for axis, name in enumerate(tuple(spec or ())):
        names = name if isinstance(name, tuple) else (name,)
        if "tp" in names:
            n = a.shape[axis] // tp
            a = np.take(a, np.arange(rank * n, (rank + 1) * n), axis=axis)
    return a


def rank_tree_from_jax(tp_params, rank: int):
    """Rank ``rank``'s parts of a host copy of a JAX ``TPParams``
    (``params``, ``pspecs``, ``tp``; leaves numpy arrays after
    ``jax.device_get``), in JAX's own tree and layout: what the JAX
    package's shardings hand that rank's device."""
    tp = int(tp_params.tp)
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside [0, {tp})")

    def cut(x, spec):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: cut(v, spec[k]) for k, v in x.items()}
        if dataclasses.is_dataclass(x):
            arrays = {f.name: cut(getattr(x, f.name), getattr(spec, f.name))
                      for f in dataclasses.fields(x)
                      if not f.metadata.get("static") and getattr(x, f.name) is not None}
            return dataclasses.replace(x, **arrays)
        return _rank_part(x, spec, rank, tp)

    return cut(tp_params.params, tp_params.pspecs)


def rank_params_from_jax(tp_params, rank: int, device="cuda"):
    """Rank ``rank``'s shard of a host copy of a JAX ``TPParams``, in the
    port's layout: the parameters ``awq_tpu_torch.parallel.deploy.
    build_tp_params`` builds for that rank."""
    return params_from_jax(rank_tree_from_jax(tp_params, rank), device=device)
