"""Group-wise weight quantization math (PyTorch port of ``awq_tpu/quant/core.py``).

Semantics mirror the reference quantizer ``awq/quantize/quantizer.py:61-103``
(group-wise asymmetric min/max INT-n quantization with a zero point).

Conventions, as in the JAX package:

- Linear weights are ``[IC, OC]`` (``y = x @ w``). Quantization groups are
  contiguous runs of ``group_size`` along the input-channel axis (axis 0).
- ``scales``/``zeros`` have shape ``[IC // group_size, OC]``.
- Rounding is ``torch.round`` (round-half-to-even), the same as ``jnp.round``.
- ``scales`` is ``(max - min) / 15.0`` as a TRUE IEEE division. Replacing it
  by ``* (1/15)`` perturbs ``scales`` by an ulp and flips ``round()`` at the
  exact .5 ties that clipping creates (clipped weights sit exactly on
  ``max_val``). The JAX package guards the same tie with ``exact_divisor``;
  eager PyTorch divides exactly as written, so no guard is needed here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _grouped(w: torch.Tensor, group_size: int) -> Tuple[torch.Tensor, int]:
    """[IC, OC] -> [n_groups, group, OC]."""
    ic, oc = w.shape
    g = ic if group_size == -1 else group_size
    if ic % g != 0:
        raise ValueError(f"IC={ic} not divisible by group_size={g}")
    return w.reshape(ic // g, g, oc), g


def quantize_groupwise(
    w: torch.Tensor,
    n_bit: int = 4,
    group_size: int = 128,
    zero_point: bool = True,
    clip_max: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize ``w [IC, OC]`` to integer codes plus scales/zeros.

    Returns ``(q uint8 [IC, OC], scales f32 [IC//G, OC], zeros f32 [IC//G, OC])``
    so that ``deq = (q - zeros) * scales``. ``clip_max`` optionally clamps
    ``|w|`` per (group, OC) first (the AWQ clip-search result).
    """
    wg, _ = _grouped(w.to(torch.float32), group_size)
    if clip_max is not None:
        cm = clip_max.to(torch.float32)[:, None, :]
        wg = torch.minimum(torch.maximum(wg, -cm), cm)
    max_int = 2**n_bit - 1
    if zero_point:
        max_val = wg.amax(dim=1, keepdim=True)
        min_val = wg.amin(dim=1, keepdim=True)
        scales = torch.clamp(max_val - min_val, min=1e-5) / float(max_int)
        zeros = torch.clamp(-torch.round(min_val / scales), 0, max_int)
    else:
        absmax = torch.clamp(wg.abs().amax(dim=1, keepdim=True), min=1e-5)
        half = 2 ** (n_bit - 1)
        scales = absmax / (half - 1)
        zeros = torch.full_like(scales, float(half))
    q = torch.clamp(torch.round(wg / scales) + zeros, 0, max_int)
    ic, oc = w.shape
    return (
        q.reshape(ic, oc).to(torch.uint8),
        scales[:, 0, :],
        zeros[:, 0, :],
    )


def dequantize_groupwise(
    q: torch.Tensor,
    scales: torch.Tensor,
    zeros: torch.Tensor,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Inverse of :func:`quantize_groupwise`: ``(q - zeros) * scales``."""
    ic, oc = q.shape
    n_g = scales.shape[0]
    qg = q.reshape(n_g, ic // n_g, oc).to(torch.float32)
    deq = (qg - zeros[:, None, :]) * scales[:, None, :]
    return deq.reshape(ic, oc).to(out_dtype)


def pseudo_quantize(
    w: torch.Tensor,
    n_bit: int = 4,
    group_size: int = 128,
    zero_point: bool = True,
    clip_max: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fake-quantize: quantize + dequantize, preserving dtype and shape."""
    q, s, z = quantize_groupwise(w, n_bit, group_size, zero_point, clip_max)
    return dequantize_groupwise(q, s, z, out_dtype=w.dtype)
