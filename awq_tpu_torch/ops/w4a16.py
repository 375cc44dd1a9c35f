"""W4A16 and W3A16 dequant matmul (PyTorch port of ``awq_tpu/ops/w4a16.py``).

``y = x @ dequant(W) (+ bias)`` with ``dequant(q) = q * scales - szeros``
per group of ``group_size`` input channels, f32 accumulation, ``y`` in
``x.dtype`` (f32, bf16 or f16). The codes are ``pack_int4``'s (4-bit, or
3-bit codes in the nibble container) or, with ``dense3``, ``pack_int3``'s
true 3-bit layout (``IC % 256 == 0``), which streams 0.75x the code bytes.

- :func:`w4a16_matmul_plain` is the plain PyTorch version (the counterpart
  of ``w4a16_matmul_xla``): unpack, dequantize to ``x.dtype``, one
  ``torch.matmul``. The CPU path and the reference the kernels are held to.
- :func:`w4a16_matmul` is the wrapper of kernel K1 (``csrc/w4a16.cuh``),
  which replaces the Pallas kernels ``w4a16_matmul_pallas`` /
  ``w4a16_matmul_stacked`` (and their TPU-only tiled and folded layouts)
  and, in its W3 mode (``csrc/w3a16.cu``), ``w3a16_matmul_stacked`` and
  ``w3a16_matmul_stacked_tiled_folded``: the GEMV entry for ``M <= 8``
  rows (decode), the tiled mma.sync entry for more (prefill). On a CPU
  tensor it runs the plain version; on a CUDA tensor it launches the
  kernel or raises. The source note in the ``.cuh`` says what bounds each
  entry on the H100 and what its design does about it.

The kernels read both packings as they are: a layer of a stacked
``[L, rows, OC]`` weight is the free view ``qweight[l]``, so none of the
TPU's scalar-prefetch layer indexing is carried over.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from awq_tpu_torch.quant.core import quantize_groupwise
from awq_tpu_torch.quant.packing import pack_int3, pack_int4, unpack_int3, unpack_int4

#: Launches of each K1 entry and of its W3 mode, counted where the wrapper
#: launches them.
LAUNCHES = {"w4a16_gemv": 0, "w4a16_gemm": 0, "w3a16_gemv": 0, "w3a16_gemm": 0}

GEMV_MAX_M = 8          # rows served by the GEMV entry
_SPLIT_K = 512          # input channels per GEMV block (csrc/w4a16.cuh)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@dataclasses.dataclass
class QLinear:
    """Packed quantized linear parameters, JAX layouts kept.

    ``qweight`` int32 ``[(L,) IC//8, OC]`` in ``pack_int4`` order, or with
    ``dense3`` ``[(L,) IC*3//32, OC]`` in ``pack_int3`` order (``w_bit`` 3
    without ``dense3`` is 3-bit codes in the nibble container);
    ``scales``/``szeros`` f32 ``[(L,) IC//G, OC]`` with
    ``szeros = scales * zeros``; ``bias`` ``[(L,) OC]`` or None.
    """

    qweight: torch.Tensor
    scales: torch.Tensor
    szeros: torch.Tensor
    bias: Optional[torch.Tensor] = None
    w_bit: int = 4
    group_size: int = 128
    dense3: bool = False

    @property
    def in_features(self) -> int:
        rows = self.qweight.shape[-2]
        return rows * 32 // 3 if self.dense3 else rows * 8

    @property
    def out_features(self) -> int:
        return self.qweight.shape[-1]


def quantize_linear(
    w: torch.Tensor,
    n_bit: int = 4,
    group_size: int = 128,
    bias: Optional[torch.Tensor] = None,
    clip_max: Optional[torch.Tensor] = None,
    scale_dtype=torch.float32,
) -> QLinear:
    """Real-quantize a ``[IC, OC]`` weight into a packed :class:`QLinear`:
    3-bit codes go to ``pack_int3`` (``dense3``) where ``IC % 256 == 0``,
    else into the nibble container, as in the JAX package."""
    g = w.shape[0] if group_size == -1 else group_size
    q, s, z = quantize_groupwise(w, n_bit=n_bit, group_size=g,
                                 clip_max=clip_max)
    dense3 = n_bit == 3 and w.shape[0] % 256 == 0
    return QLinear(
        qweight=pack_int3(q) if dense3 else pack_int4(q),
        scales=s.to(scale_dtype),
        szeros=(s * z).to(scale_dtype),
        bias=bias,
        w_bit=n_bit,
        group_size=g,
        dense3=dense3,
    )


def unpack_codes(qweight: torch.Tensor, dense3: bool = False,
                 out_dtype=torch.float32) -> torch.Tensor:
    """The codes ``[IC, OC]`` of a 2-D packed weight of either format."""
    if dense3:
        return unpack_int3(qweight, out_dtype=out_dtype)
    return unpack_int4(qweight, out_dtype=out_dtype)


def dequantize(qweight: torch.Tensor, scales: torch.Tensor,
               szeros: torch.Tensor, group_size: int,
               dtype: torch.dtype, dense3: bool = False) -> torch.Tensor:
    """``q * scales - szeros`` in f32, rounded once to ``dtype`` -> ``[IC, OC]``."""
    q = unpack_codes(qweight, dense3)
    ic = q.shape[0]
    qg = q.reshape(ic // group_size, group_size, -1)
    w = qg * scales[:, None, :] - szeros[:, None, :]
    return w.reshape(ic, -1).to(dtype)


def w4a16_matmul_plain(x: torch.Tensor, qweight: torch.Tensor,
                       scales: torch.Tensor, szeros: torch.Tensor,
                       group_size: int,
                       bias: Optional[torch.Tensor] = None,
                       dense3: bool = False) -> torch.Tensor:
    """Plain version of K1: ``x [M, IC] -> [M, OC]`` in ``x.dtype``."""
    w = dequantize(qweight, scales, szeros, group_size, x.dtype, dense3)
    out = torch.matmul(x, w)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"w4a16_matmul: {msg}")


def w4a16_matmul(x: torch.Tensor, qweight: torch.Tensor,
                 scales: torch.Tensor, szeros: torch.Tensor,
                 group_size: int,
                 bias: Optional[torch.Tensor] = None,
                 dense3: bool = False) -> torch.Tensor:
    """K1 wrapper: ``x [M, IC] @ dequant(qweight) (+ bias)`` in ``x.dtype``.

    CPU tensors take :func:`w4a16_matmul_plain`. CUDA tensors launch the
    GEMV entry (``M <= 8``) or the tiled entry of the format's library
    (``w4a16``, or ``w3a16`` with ``dense3``), after checking what the
    kernels take: f32, bf16 or f16 ``x`` with a bias of its dtype, int32
    codes, f32 scales, contiguous operands on one device, a group size
    that is a multiple of 8 and divides IC (the whole IC included).
    """
    if x.device.type == "cpu":
        return w4a16_matmul_plain(x, qweight, scales, szeros, group_size, bias,
                                  dense3)
    if not x.is_cuda:
        raise ValueError(f"w4a16_matmul: unsupported device {x.device}")
    m, ic = x.shape
    rows = ic * 3 // 32 if dense3 else ic // 8
    _check(qweight.dim() == 2 and qweight.shape[0] == rows
           and ic % (256 if dense3 else 64) == 0,
           f"qweight {tuple(qweight.shape)} does not match IC={ic}"
           + (" (dense3 needs IC % 256 == 0)" if dense3 else ""))
    oc = qweight.shape[1]
    _check(group_size > 0 and ic % group_size == 0 and group_size % 8 == 0,
           f"group_size={group_size} must be a multiple of 8 dividing IC={ic}")
    n_g = ic // group_size
    _check(x.dtype in _DTYPE_CODE, f"x must be f32, bf16 or f16, got {x.dtype}")
    _check(qweight.dtype == torch.int32, "qweight must be int32")
    _check(scales.dtype == torch.float32 and szeros.dtype == torch.float32,
           "scales/szeros must be float32")
    _check(tuple(scales.shape) == (n_g, oc) and tuple(szeros.shape) == (n_g, oc),
           f"scales/szeros must be [{n_g}, {oc}]")
    if bias is not None:
        _check(bias.dtype == x.dtype and tuple(bias.shape) == (oc,)
               and bias.is_contiguous(), f"bias must be contiguous {x.dtype} [OC]")
    tensors = [x, qweight, scales, szeros] + ([bias] if bias is not None else [])
    _check(all(t.device == x.device for t in tensors),
           "operands on different devices")
    _check(all(t.is_contiguous() for t in tensors), "operands must be contiguous")
    out = torch.empty((m, oc), dtype=x.dtype, device=x.device)
    if m == 0:
        return out

    from awq_tpu_torch import _build

    fmt = "w3a16" if dense3 else "w4a16"
    lib = _build.load(fmt)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bias_ptr = bias.data_ptr() if bias is not None else None
    dtype = _DTYPE_CODE[x.dtype]
    if m <= GEMV_MAX_M:
        partial = torch.empty((-(-ic // _SPLIT_K), m, oc), dtype=torch.float32,
                              device=x.device)
        vec = int(oc % 4 == 0 and all(t.data_ptr() % 16 == 0
                                      for t in (qweight, scales, szeros)))
        fn = getattr(lib, f"awq_{fmt}_gemv")
        _build.declare(fn, *([_build.P] * 7), *([_build.I] * 7), _build.P)
        err = fn(x.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                 szeros.data_ptr(), bias_ptr, out.data_ptr(),
                 partial.data_ptr(), m, ic, oc, group_size, _SPLIT_K, vec,
                 dtype, stream)
        what = f"{fmt}_gemv"
    else:
        _check(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
        fn = getattr(lib, f"awq_{fmt}_gemm")
        _build.declare(fn, *([_build.P] * 6), *([_build.I] * 5), _build.P)
        err = fn(x.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                 szeros.data_ptr(), bias_ptr, out.data_ptr(), m, ic, oc,
                 group_size, dtype, stream)
        what = f"{fmt}_gemm"
    _build.check(lib, err, what)
    LAUNCHES[what] += 1
    return out


def _apply(qweight, scales, szeros, bias, group_size, dense3, x, impl: str):
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    fn = w4a16_matmul_plain if impl == "plain" else w4a16_matmul
    out = fn(x2, qweight, scales, szeros, group_size, bias, dense3)
    return out.reshape(*lead, qweight.shape[-1])


def qlinear_apply(ql: QLinear, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Apply a 2-D quantized linear layer: ``x [..., IC] @ W_deq + bias``.

    ``impl="plain"`` runs the plain PyTorch version whatever the device
    (the reference a kernel run is held to); ``"auto"`` goes through the
    K1 wrapper."""
    return _apply(ql.qweight, ql.scales, ql.szeros, ql.bias, ql.group_size,
                  ql.dense3, x, impl)


def qlinear_apply_stacked(ql: QLinear, layer_idx: int, x: torch.Tensor,
                          impl: str = "auto") -> torch.Tensor:
    """Apply layer ``layer_idx`` of a stacked ``QLinear [L, ...]``; the
    layer's operands are free views of the stack."""
    bias = ql.bias[layer_idx] if ql.bias is not None else None
    return _apply(ql.qweight[layer_idx], ql.scales[layer_idx],
                  ql.szeros[layer_idx], bias, ql.group_size, ql.dense3, x, impl)
