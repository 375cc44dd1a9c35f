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
  rows (decode; one launch over the host plan of :func:`gemv_plan`: column
  tiles, IC splits merged in a cluster, ring slots), the wgmma GEMM entry
  for more (prefill), over the host plan of :func:`gemm_plan` (orientation,
  token tile, IC splits). On a CPU
  tensor it runs the plain version; on a CUDA tensor it launches the
  kernel or raises. The source note in the ``.cuh`` says what bounds each
  entry on the H100 and what its design does about it.

The kernels read both packings as they are: a layer of a stacked
``[L, rows, OC]`` weight is the free view ``qweight[l]``, so none of the
TPU's scalar-prefetch layer indexing is carried over.

The int8-activation prefill (``cfg.prefill_a8``; ``csrc/w8a8.cu``): x is
quantized per token (``ops/w8a8.py::quant_per_token``) and multiplied in
int8 with int32 sums, then ``y = (f32(acc) * scol) * sx`` rounded once to
``x.dtype``:

- :func:`w4a8_matmul` is the wrapper of K10, the counterpart of the Pallas
  kernel ``w4a8_matmul_stacked_tiled_folded`` (row 7): it requantizes the
  W4 codes to int8 per output column inside the kernel
  (:func:`requant_w8`'s arithmetic, as a 16-entry table per column and
  group) into wgmma's B tile, with x quantized in the kernel's channel
  order (``ops/w8a8.py::permute64``), over the plan of :func:`gemm_plan`;
- :func:`w8a8_matmul` is the wrapper of K11, the counterpart of
  ``w8a8_matmul_stacked_tiled`` (row 8), over the int8 prefill weight cache
  :class:`W8Stack` that :func:`attach_w8_caches` builds once
  (``RuntimeConfig.prefill_w8``): wgmma s8 over the plan of
  :func:`gemm_plan`, with int32 split partials.

:func:`qlinear_apply_stacked` routes a prefill (``a8``) as the JAX package
does: K11 from ``_W8_MIN_M`` rows where the layer has a cache, else K10
from ``_A8_MIN_M`` rows at group 128, else K1; ``pack_int3`` weights take
K1 whatever ``a8`` says. The two thresholds take the JAX package's
environment overrides (``AWQ_TPU_W8_MIN_M``, ``AWQ_TPU_A8_MIN_M``), read at
each call here where JAX reads them once at import.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, Optional, Tuple

import torch

from awq_tpu_torch.ops.w8a8 import quant_per_token, quant_per_token_plain
from awq_tpu_torch.quant.core import quantize_groupwise
from awq_tpu_torch.quant.packing import pack_int3, pack_int4, unpack_int3, unpack_int4

#: Launches of each K1 entry and of its W3 mode, of K10 (``w4a8_gemm``) and
#: of K11 (``w8a8_gemm``), counted where the wrapper launches them.
LAUNCHES = {"w4a16_gemv": 0, "w4a16_gemm": 0, "w3a16_gemv": 0, "w3a16_gemm": 0,
            "w4a8_gemm": 0, "w8a8_gemm": 0}

GEMV_MAX_M = 8          # rows served by the GEMV entry
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: Input channels of one ring stage of the wgmma GEMMs: K1 W4 (8 code rows),
#: K1 W3 (one 256-channel pack_int3 chunk, 24 code rows), K11 (128 int8),
#: K10 (16 code rows requantized to 128 int8).
STAGE_K = {"w4a16": 64, "w3a16": 256, "w8a8": 128, "w4a8": 128}
GEMM_BN = 128           # output columns of a block
_N_SM: Dict[int, int] = {}


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """How K1's GEMM entry, K10 or K11 covers one product ``[M, IC] x [IC, OC]``.

    ``swap``: the weights are wgmma's 64-row operand and the ``tile_m``
    tokens of a block its N, so that no tensor-core row works on padding
    (K1 always, its dequantized weights in registers; K11 up to 64 rows,
    above that blocks of 128 tokens x 128 columns; K10 never: 128 x 128
    tiles, one requantized stage feeding 128 tokens). ``blocks_per_sm``: how
    many blocks of that tile the kernel fits on an SM. ``splits``: the IC
    stages are cut into this many ranges, split ``z`` taking stages
    ``[z*n//splits, (z+1)*n//splits)``; a second launch sums their
    partials in split order (f32 for K1; int32 for K10 and K11).
    """

    swap: bool
    tile_m: int
    stage_k: int
    n_stages: int
    tiles: int
    blocks_per_sm: int
    splits: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def edges(self, ic: int):
        """The channel offsets where the splits start, and IC."""
        n = self.n_stages
        return [z * n // self.splits * self.stage_k for z in range(self.splits)] + [ic]


def gemm_plan(m: int, ic: int, oc: int, kind: str = "w4a16", n_sm: int = 132) -> GemmPlan:
    """The host-side plan of one wgmma GEMM (``kind``: ``w4a16``, ``w3a16``,
    ``w8a8`` or ``w4a8``): the token tile by M (16, 32, 64, then 128; K11
    turns to 128 x 128 tiles from 65 rows, K10 takes them at every M), and
    where the tiles leave SMs idle, as many IC splits as one wave of blocks
    holds (never more than the stages)."""
    stage_k = STAGE_K[kind]
    k11 = kind == "w8a8"
    tile_m = 128 if kind == "w4a8" else next((t for t in (16, 32, 64) if m <= t), 128)
    swap = kind in ("w4a16", "w3a16") or (k11 and tile_m <= 64)
    bps = 2 if tile_m <= 64 else 1
    tiles = -(-oc // GEMM_BN) * -(-m // tile_m)
    n_stages = -(-ic // stage_k)
    splits = 1 if tiles >= n_sm else max(1, min(n_sm * bps // tiles, n_stages))
    return GemmPlan(swap=swap, tile_m=tile_m, stage_k=stage_k, n_stages=n_stages,
                    tiles=tiles, blocks_per_sm=bps, splits=splits)


#: The GEMV entry's block: output columns, the most IC splits of a column
#: tile (one cluster), the most ring slots, and a code row's padding in
#: words (csrc/w4a16.cuh, namespace gv).
GEMV_BN = 128
GEMV_MAX_CLUSTER = 8
GEMV_MAX_STAGES = 5
_GEMV_PAD = 4
_GEMV_ROWS = {"w4a16": 8, "w3a16": 24}        # code rows of one ring stage
_SMEM_SM = 227 * 1024     # shared memory a block may take
_GEMV_SMEM = 113 * 1024   # what two blocks an SM leave each
_GEMV_X = 16 * 1024       # x a block stages, where splits allow


@dataclasses.dataclass(frozen=True)
class GemvPlan:
    """How K1's GEMV entry covers one product ``[M <= 8, IC] x [IC, OC]``.

    Blocks of ``tile_n`` output columns; IC in ``n_stages`` stages of
    ``stage_k`` channels (one packing chunk), cut into ``splits`` ranges
    (split ``z`` takes stages ``[z*n//splits, (z+1)*n//splits)``), the
    ranges of one column tile a thread-block cluster that adds them in rank
    order. Each block stages x over its range in shared memory and streams
    the range through a ring of ``stages`` slots of ``stage_bytes`` (the code
    rows and the ``ns`` scale rows of the groups a stage spans); ``smem`` is
    its shared memory. ``tc``: the tensor-core body (bf16/f16 x and a group
    size that is a multiple of 16), else the f32 one."""

    tile_n: int
    stage_k: int
    n_stages: int
    tiles: int
    splits: int
    stages: int
    ns: int
    stage_bytes: int
    smem: int
    tc: bool

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    @property
    def cluster(self) -> int:
        return self.splits

    def edges(self, ic: int):
        """The channel offsets where the splits start, and IC."""
        n = self.n_stages
        return [z * n // self.splits * self.stage_k for z in range(self.splits)] + [ic]

    def ranges(self):
        """``(first stage, stage count)`` of each split."""
        n = self.n_stages
        return [(z * n // self.splits, (z + 1) * n // self.splits - z * n // self.splits)
                for z in range(self.splits)]


def stage_groups(ic: int, group_size: int, stage_k: int) -> int:
    """The most quantization groups one stage of ``stage_k`` channels spans."""
    return max((k0 + stage_k - 1) // group_size - k0 // group_size + 1
               for k0 in range(0, ic, stage_k))


def gemv_smem(tc: bool, m: int, rng: int, group_size: int, stages: int, sb: int) -> int:
    """Shared memory of a GEMV block (``gv::layout``): x over ``rng``
    channels and its group sums, the ring, its mbarriers."""
    xw = rng // 2 + 8 if tc else rng + 4
    ring_off = -(-(m * xw * 4 + (m * (rng // group_size + 2) * 4 if tc else 0)) // 128) * 128
    return ring_off + stages * sb + 16 * stages


def gemv_plan(m: int, ic: int, oc: int, group_size: int, kind: str = "w4a16",
              n_sm: int = 132, x_dtype: torch.dtype = torch.bfloat16) -> GemvPlan:
    """The host-side plan of one GEMV call (``kind``: ``w4a16`` or
    ``w3a16``; ``m <= 8``): column tiles of 128; where they are fewer than
    three a streaming multiprocessor, each tile's IC is split into as many
    ranges (a cluster, at most 8, never more than the stages) as bring the
    blocks to three an SM, and more while a block's x exceeds 16 KB; a ring
    as deep as the longest range plus one slot (every chunk of a short
    range in flight at once), at most 5 slots, in what two blocks an SM
    leave beside x (113 KB), else in a whole SM's 227 KB; more splits where
    even that does not hold x and two slots. (On the H100 a block streams
    at a few GB/s, so more blocks in flight beat deeper rings: 5 slots ran
    down at 8 rows 1.4x faster than 9, and 8 splits of wqkv 8% faster than
    6.)"""
    if not 1 <= m <= GEMV_MAX_M:
        raise ValueError(f"gemv_plan: m={m} outside [1, {GEMV_MAX_M}]")
    stage_k = STAGE_K[kind]
    n_stages = ic // stage_k
    tiles = -(-oc // GEMV_BN)
    tc = x_dtype != torch.float32 and group_size % 16 == 0
    splits = max(1, min(GEMV_MAX_CLUSTER, n_stages, -(-3 * n_sm // tiles)))
    # more splits where a block's x would crowd its SM out of ring slots
    most = min(GEMV_MAX_CLUSTER, n_stages)
    while splits < most and m * -(-n_stages // splits) * stage_k * (2 if tc else 4) > _GEMV_X:
        splits += 1
    ns = stage_groups(ic, group_size, stage_k)
    sb = _GEMV_ROWS[kind] * (GEMV_BN + _GEMV_PAD) * 4 + 2 * ns * GEMV_BN * 4
    while True:
        longest = -(-n_stages // splits)
        rng = longest * stage_k
        want = max(2, min(GEMV_MAX_STAGES, longest + 1))
        for budget in (_GEMV_SMEM, _SMEM_SM):
            stages = want
            while stages > 2 and gemv_smem(tc, m, rng, group_size, stages, sb) > budget:
                stages -= 1
            smem = gemv_smem(tc, m, rng, group_size, stages, sb)
            if smem <= budget:
                break
        if smem <= _SMEM_SM or splits >= min(GEMV_MAX_CLUSTER, n_stages):
            break
        splits += 1
    if smem > _SMEM_SM:
        raise ValueError(f"gemv_plan: x of {m} rows over IC={ic} does not fit a block")
    return GemvPlan(tile_n=GEMV_BN, stage_k=stage_k, n_stages=n_stages, tiles=tiles,
                    splits=splits, stages=stages, ns=ns, stage_bytes=sb, smem=smem, tc=tc)


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _N_SM:
        _N_SM[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _N_SM[idx]


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
    GEMV entry (``M <= 8``, one launch over :func:`gemv_plan`) or the wgmma
    GEMM entry of the format's library (``w4a16``, or ``w3a16`` with
    ``dense3``; f32 ``x`` rounded to bf16 for it, and with more than one
    split a second launch that sums the partials), after checking what the
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
        if x.data_ptr() % 16:
            x = x.clone()      # x is staged by 16-byte loads
        plan = gemv_plan(m, ic, oc, group_size, fmt, _sm_count(x.device), x.dtype)
        vec = int(oc % 4 == 0 and all(t.data_ptr() % 16 == 0
                                      for t in (qweight, scales, szeros)))
        fn = getattr(lib, f"awq_{fmt}_gemv")
        _build.declare(fn, *([_build.P] * 6), *([_build.I] * 8), _build.P)
        err = fn(x.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                 szeros.data_ptr(), bias_ptr, out.data_ptr(), m, ic, oc, group_size,
                 plan.splits, plan.stages, vec, dtype, stream)
        what = f"{fmt}_gemv"
    else:
        # f32 x enters the tensor cores as bf16, rounded here once
        xk = x.to(torch.bfloat16) if x.dtype == torch.float32 else x
        _check(xk.data_ptr() % 16 == 0, "x must be 16-byte aligned")
        plan = gemm_plan(m, ic, oc, fmt, _sm_count(x.device))
        partial = (torch.empty((plan.splits, m, oc), dtype=torch.float32, device=x.device)
                   if plan.splits > 1 else None)
        fn = getattr(lib, f"awq_{fmt}_gemm")
        _build.declare(fn, *([_build.P] * 7), *([_build.I] * 7), _build.P)
        err = fn(xk.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                 szeros.data_ptr(), bias_ptr, out.data_ptr(),
                 None if partial is None else partial.data_ptr(), m, ic, oc,
                 group_size, plan.tile_m, plan.splits, dtype, stream)
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
                          impl: str = "auto", a8: bool = False,
                          w8stack: Optional["W8Stack"] = None) -> torch.Tensor:
    """Apply layer ``layer_idx`` of a stacked ``QLinear [L, ...]``; the
    layer's operands are free views of the stack.

    ``a8`` (a prefill under ``cfg.prefill_a8``) routes the nibble-container
    weights as ``awq_tpu/ops/w4a16.py:1397-1409`` does: K11 over
    ``w8stack``'s layer from ``_W8_MIN_M`` rows, else K10 from
    ``_A8_MIN_M`` rows at group 128, else K1. The bias is added after the
    int8 product in ``x.dtype``, as JAX adds it."""
    bias = ql.bias[layer_idx] if ql.bias is not None else None
    if a8 and not ql.dense3:
        x2 = x.reshape(-1, x.shape[-1])
        m, plain = x2.shape[0], impl == "plain"
        out = None
        if w8stack is not None and m >= _min_rows("AWQ_TPU_W8_MIN_M", _W8_MIN_M):
            fn = w8a8_matmul_plain if plain else w8a8_matmul
            out = fn(x2, w8stack.w8[layer_idx], w8stack.scol[layer_idx])
        elif m >= _min_rows("AWQ_TPU_A8_MIN_M", _A8_MIN_M) and ql.group_size == 128:
            fn = w4a8_matmul_plain if plain else w4a8_matmul
            out = fn(x2, ql.qweight[layer_idx], ql.scales[layer_idx],
                     ql.szeros[layer_idx], ql.group_size)
        if out is not None:
            if bias is not None:
                out = out + bias.to(out.dtype)
            return out.reshape(*x.shape[:-1], ql.out_features)
    return _apply(ql.qweight[layer_idx], ql.scales[layer_idx],
                  ql.szeros[layer_idx], bias, ql.group_size, ql.dense3, x, impl)


# ---- the int8-activation prefill: K10, K11 and the int8 weight cache ----------

# Rows from which a prefill matmul takes K10 (the requant in the kernel
# amortizes only over long inputs) and K11 (the cache), as in the JAX
# package; its environment variables override them.
_A8_MIN_M = 512
_W8_MIN_M = 32
_COL_RATIO = 15.0 / 127.0   # the per-column scale bounds |code - z| <= 15


def _min_rows(env: str, default: int) -> int:
    return int(os.environ.get(env, default))


@dataclasses.dataclass
class W8Stack:
    """The int8 prefill weight cache of a stacked W4 :class:`QLinear`
    (the JAX package's ``W8Stack``), in the port's own layout: ``w8`` int8
    ``[L, OC, IC]`` (each output column's IC codes contiguous, the
    column-major B operand of the int8 ``mma``) and ``scol`` f32 ``[L, OC]``,
    the per-column dequant scale. IC*OC bytes per layer."""

    w8: torch.Tensor
    scol: torch.Tensor


def requant_w8(qweight: torch.Tensor, scales: torch.Tensor, szeros: torch.Tensor,
               group_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's W4 codes requantized per output column: ``(w8 int8
    [OC, IC], scol f32 [OC])``, the arithmetic of the TPU kernel
    ``_w4a8_kernel_folded`` and of ``build_w8_stack``, every step one f32
    operation in the same order: bf16 ``s`` and ``sz`` (the folded layout's
    values), ``z = sz / s``, ``scol = max(max(0, max_g s) * f32(15/127),
    1e-12)``, ``w8 = clip(round_half_even(((128 + q) - (128 + z)) *
    (s * (1 / scol))), -127, 127)``. The ``128 +`` on both sides drops z's
    low bits as the TPU's bf16-bitpack arithmetic does; the divisions are
    by tensors (true divisions on the card too)."""
    ic = qweight.shape[0] * 8
    s = scales.to(torch.bfloat16).float()
    sz = szeros.to(torch.bfloat16).float()
    z = sz / s
    scol = torch.clamp_min(torch.clamp_min(s.amax(dim=0), 0.0) * _COL_RATIO, 1e-12)
    sinv = s * (torch.ones_like(scol) / scol)
    wf = unpack_int4(qweight, out_dtype=torch.float32).add_(128.0)
    wf = wf.view(ic // group_size, group_size, -1)
    wf.sub_((z + 128.0)[:, None]).mul_(sinv[:, None])
    w8 = wf.round_().clamp_(-127, 127).to(torch.int8).view(ic, -1)
    return w8.t().contiguous(), scol


def _w8_eligible(p) -> bool:
    """A stacked W4 QLinear in the nibble layout at group 128: the JAX
    package's condition (folded, 4-bit, not dense3, stacked; its fold
    exists at group 128 only)."""
    return (isinstance(p, QLinear) and p.w_bit == 4 and not p.dense3
            and p.qweight.dim() == 3 and p.group_size == 128)


def build_w8_stack(ql: QLinear) -> W8Stack:
    """Requantize every layer of a stacked W4 QLinear (:func:`requant_w8`)
    into one preallocated cache: each layer is written in place, so the
    peak holds the cache once plus one layer's temporaries (stacking the
    per-layer results would hold it twice)."""
    if not _w8_eligible(ql):
        raise ValueError("the int8 prefill cache needs a stacked W4 QLinear in the "
                         "nibble layout at group 128")
    n_layers, dev = ql.qweight.shape[0], ql.qweight.device
    w8 = torch.empty((n_layers, ql.out_features, ql.in_features), dtype=torch.int8,
                     device=dev)
    scol = torch.empty((n_layers, ql.out_features), dtype=torch.float32, device=dev)
    for l in range(n_layers):
        w8[l], scol[l] = requant_w8(ql.qweight[l], ql.scales[l], ql.szeros[l],
                                    ql.group_size)
    return W8Stack(w8=w8, scol=scol)


def w8_cache_cost(layers: dict) -> Dict[str, int]:
    """Bytes of the int8 prefill cache per eligible linear name: ``L * IC *
    OC`` codes (the per-column scales add 4 bytes per column and layer)."""
    return {name: p.qweight.shape[0] * p.in_features * p.out_features
            for name, p in layers.items() if _w8_eligible(p)}


def _device_free_bytes(device: torch.device) -> Optional[int]:
    """Free device memory, or None where there is no card to ask."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[0])


def attach_w8_caches(layers: dict, budget_bytes: Optional[int] = None,
                     headroom_bytes: int = 1 << 30) -> dict:
    """``layers`` plus a ``<name>_w8`` :class:`W8Stack` for every eligible
    linear (``RuntimeConfig.prefill_w8``); the caller sets
    ``cfg.prefill_a8``. ``budget_bytes`` builds the deepest-IC names first
    (where K10's requant costs most) until the budget is spent and leaves
    the rest on K10, as the JAX package does.

    The fit guard refuses (ValueError) a cache larger than the free device
    memory less ``headroom_bytes``, with or without a budget: the JAX
    package skips the check when a budget is given
    (``awq_tpu/ops/w4a16.py:1250``), and a budget above what is free would
    then fail halfway through the build."""
    out = dict(layers)
    cost = w8_cache_cost(layers)
    take = list(cost)
    if budget_bytes is not None and budget_bytes > 0:
        take, spent = [], 0
        for name in sorted(cost, key=lambda n: -layers[n].in_features):
            if spent + cost[name] <= budget_bytes:
                take.append(name)
                spent += cost[name]
        skipped = sorted(set(cost) - set(take))
        if skipped:
            warnings.warn(f"prefill_w8: budget {budget_bytes / 2**30:.2f} GiB covers "
                          f"{sorted(take)} ({spent / 2**30:.2f} GiB); {skipped} stay on "
                          "the in-kernel-requant a8 path")
    need = sum(cost[n] for n in take)
    if take:
        free = _device_free_bytes(layers[take[0]].qweight.device)
        if free is not None and need > max(free - headroom_bytes, 0):
            raise ValueError(
                f"prefill_w8: the int8 weight cache needs {need / 2**30:.2f} GiB but only "
                f"{free / 2**30:.2f} GiB of device memory is free (headroom "
                f"{headroom_bytes / 2**30:.1f} GiB). Set RuntimeConfig.prefill_w8_budget_gb "
                "below what is free (deepest-IC layers first) or disable prefill_w8.")
    for name in take:
        out[name + "_w8"] = build_w8_stack(layers[name])
    return out


def w8a8_matmul_plain(x: torch.Tensor, w8: torch.Tensor,
                      scol: torch.Tensor) -> torch.Tensor:
    """Plain version of K11: ``x [M, IC]`` against one layer of the cache
    (``w8 [OC, IC]``, ``scol [OC]``) -> ``[M, OC]`` in ``x.dtype``. The
    int8 product is summed in f64, exact for these integers."""
    xq, sx = quant_per_token_plain(x)
    acc = torch.matmul(xq.double(), w8.double().t())
    return ((acc.float() * scol) * sx).to(x.dtype)


def w4a8_matmul_plain(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                      szeros: torch.Tensor, group_size: int) -> torch.Tensor:
    """Plain version of K10: :func:`requant_w8`, then K11's plain version."""
    return w8a8_matmul_plain(x, *requant_w8(qweight, scales, szeros, group_size))


def _check_a8_x(x: torch.Tensor, what: str) -> None:
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous f32, bf16 or f16 [M, IC], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.shape[1] % 64:
        raise ValueError(f"{what}: IC={x.shape[1]} must be a multiple of 64")


def _launch_a8(what: str, x: torch.Tensor, oc: int, weights, group_size=None):
    """Quantize x (one launch; in K10's channel order for K10), then run K10
    (``group_size`` given) or K11 over the plan of :func:`gemm_plan` into a
    new [M, OC]."""
    m, ic = x.shape
    out = torch.empty((m, oc), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    k10 = group_size is not None
    xq, sx = quant_per_token(x, perm=k10)

    from awq_tpu_torch import _build

    lib = _build.load("w8a8")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [xq.data_ptr(), sx.data_ptr(), *(t.data_ptr() for t in weights), out.data_ptr()]
    plan = gemm_plan(m, ic, oc, "w4a8" if k10 else "w8a8", _sm_count(x.device))
    partial = (torch.empty((plan.splits, m, oc), dtype=torch.int32, device=x.device)
               if plan.splits > 1 else None)
    pp = None if partial is None else partial.data_ptr()
    if k10:
        scol = (torch.empty((oc,), dtype=torch.float32, device=x.device)
                if plan.splits > 1 else None)
        fn = lib.awq_w4a8_gemm
        _build.declare(fn, *([_build.P] * 8), *([_build.I] * 6), _build.P)
        err = fn(*ptrs, pp, None if scol is None else scol.data_ptr(), m, ic, oc, group_size,
                 plan.splits, _DTYPE_CODE[x.dtype], stream)
    else:
        fn = lib.awq_w8a8_gemm
        _build.declare(fn, *([_build.P] * 6), *([_build.I] * 6), _build.P)
        err = fn(*ptrs, pp, m, ic, oc, plan.tile_m, plan.splits, _DTYPE_CODE[x.dtype], stream)
    _build.check(lib, err, what)
    LAUNCHES[what] += 1
    return out


def w8a8_matmul(x: torch.Tensor, w8: torch.Tensor, scol: torch.Tensor) -> torch.Tensor:
    """K11 wrapper: ``x [M, IC]`` against one layer of the int8 cache
    (``w8`` int8 ``[OC, IC]``, ``scol`` f32 ``[OC]``, free views of a
    :class:`W8Stack`) -> ``[M, OC]`` in ``x.dtype``. CPU tensors take
    :func:`w8a8_matmul_plain`; CUDA tensors launch the quantization kernel
    and K11, after checking what they take: contiguous operands on one
    device, IC a multiple of 64, 16-byte aligned codes."""
    if x.device.type == "cpu":
        return w8a8_matmul_plain(x, w8, scol)
    if not x.is_cuda:
        raise ValueError(f"w8a8_matmul: unsupported device {x.device}")
    _check_a8_x(x, "w8a8_matmul")
    ic = x.shape[1]
    if (w8.dtype != torch.int8 or w8.dim() != 2 or w8.shape[1] != ic
            or scol.dtype != torch.float32 or tuple(scol.shape) != (w8.shape[0],)):
        raise ValueError(f"w8a8_matmul: w8 must be int8 [OC, {ic}] and scol f32 [OC], got "
                         f"{w8.dtype} {tuple(w8.shape)} and {scol.dtype} {tuple(scol.shape)}")
    if not all(t.device == x.device and t.is_contiguous() for t in (w8, scol)):
        raise ValueError("w8a8_matmul: operands must be contiguous and on x's device")
    if w8.data_ptr() % 16:
        raise ValueError("w8a8_matmul: w8 must be 16-byte aligned")
    return _launch_a8("w8a8_gemm", x, w8.shape[0], (w8, scol))


def w4a8_matmul(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                szeros: torch.Tensor, group_size: int) -> torch.Tensor:
    """K10 wrapper: ``x [M, IC]`` against one layer's ``pack_int4`` codes
    (int32 ``[IC/8, OC]``) and f32 ``scales``/``szeros`` ``[IC/G, OC]``,
    requantized to int8 per column inside the kernel -> ``[M, OC]`` in
    ``x.dtype``. CPU tensors take :func:`w4a8_matmul_plain`; CUDA tensors
    launch the quantization kernel and K10, after checking contiguous
    operands on one device, IC a multiple of 64 and a group size that is a
    multiple of 64 dividing IC."""
    if x.device.type == "cpu":
        return w4a8_matmul_plain(x, qweight, scales, szeros, group_size)
    if not x.is_cuda:
        raise ValueError(f"w4a8_matmul: unsupported device {x.device}")
    _check_a8_x(x, "w4a8_matmul")
    ic = x.shape[1]
    if qweight.dtype != torch.int32 or qweight.dim() != 2 or qweight.shape[0] != ic // 8:
        raise ValueError(f"w4a8_matmul: qweight must be int32 [{ic // 8}, OC], got "
                         f"{qweight.dtype} {tuple(qweight.shape)}")
    oc = qweight.shape[1]
    if group_size <= 0 or group_size % 64 or ic % group_size:
        raise ValueError(f"w4a8_matmul: group_size={group_size} must be a multiple of 64 "
                         f"dividing IC={ic}")
    n_g = ic // group_size
    if not all(t.dtype == torch.float32 and tuple(t.shape) == (n_g, oc)
               for t in (scales, szeros)):
        raise ValueError(f"w4a8_matmul: scales/szeros must be f32 [{n_g}, {oc}]")
    if not all(t.device == x.device and t.is_contiguous() for t in (qweight, scales, szeros)):
        raise ValueError("w4a8_matmul: operands must be contiguous and on x's device")
    return _launch_a8("w4a8_gemm", x, oc, (qweight, scales, szeros), group_size)
