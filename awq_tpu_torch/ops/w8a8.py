"""Per-token int8 quantization of activations (PyTorch port of
``awq_tpu/ops/w8a8.py::quant_per_token``).

``x [M, IC] -> (xq int8 [M, IC], sx f32 [M, 1])`` with ``sx = max(absmax(
f32(x)), 1e-5) * f32(1/127)`` per row and ``xq = clip(round_half_even(
f32(x) / sx), -128, 127)``: the activations of the int8 prefill matmuls
(K10, K11 in ``ops/w4a16.py``). The JAX function writes ``/ 127.0``, but
the package only ever runs it inside ``jit``, where XLA turns a division
by a constant into a multiplication by its f32 reciprocal (a division by a
tensor stays a true division); the port computes what the package runs.
``x / sx`` is a true division: the plain version divides by a tensor, the
kernel uses ``__fdiv_rn``.

:func:`quant_per_token` is the wrapper of a small hand kernel in
``csrc/w8a8.cu``, which replaces the plain version's six launches per
linear with one: one block a row, one pass over it (a thread's 16-channel
chunk loaded into registers as 16-byte vectors, the absmax by shuffles and
one shared-memory round, the codes from the registers, stored as a 16-byte
word; with ``perm`` the 8x8 byte transpose of a 64-channel block across the
four lanes that hold it, by byte permutes and shuffles). A row wider than
32768 channels is taken in passes of that many, and read twice. On a CPU
tensor it runs :func:`quant_per_token_plain`, on a CUDA tensor it launches
the kernel or raises. JAX computes it in XLA; the rest of that JAX module (the W8A8 linears of the vision towers) is ROADMAP
queue A, item 15.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: Launches of the quantization kernel, counted where the wrapper launches it.
LAUNCHES = {"quant_per_token": 0}

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def quant_per_token_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``(xq int8 [..., IC], sx f32 [..., 1])``."""
    xf = x.float()
    sx = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-5) * (1.0 / 127.0)
    xq = torch.clamp(torch.round(xf / sx), -128, 127).to(torch.int8)
    return xq, sx


def permute64(xq: torch.Tensor) -> torch.Tensor:
    """K10's channel order: within each 64-channel block, channel ``8s + r``
    moves to ``8r + s`` (an 8x8 transpose; its own inverse). ``IC % 64 == 0``."""
    m, ic = xq.shape
    return xq.view(m, ic // 64, 8, 8).transpose(-1, -2).reshape(m, ic)


def quant_per_token(x: torch.Tensor, perm: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wrapper: ``x [M, IC]`` (f32, bf16 or f16, contiguous) ->
    ``(xq int8 [M, IC], sx f32 [M, 1])``; with ``perm`` the codes in K10's
    channel order (:func:`permute64`, ``IC % 64 == 0``), written so by the
    same launch."""
    if x.device.type == "cpu":
        xq, sx = quant_per_token_plain(x)
        return (permute64(xq) if perm else xq), sx
    if not x.is_cuda:
        raise ValueError(f"quant_per_token: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in DTYPE_CODE or not x.is_contiguous():
        raise ValueError(f"quant_per_token: x must be a contiguous f32, bf16 or f16 "
                         f"[M, IC], got {x.dtype} {tuple(x.shape)}")
    m, ic = x.shape
    if perm and ic % 64:
        raise ValueError(f"quant_per_token: perm needs IC % 64 == 0, got {ic}")
    if x.data_ptr() % 16:
        x = x.clone()         # 16-byte vectors: a fresh allocation is aligned
    xq = torch.empty((m, ic), dtype=torch.int8, device=x.device)
    sx = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m == 0:
        return xq, sx

    from awq_tpu_torch import _build

    lib = _build.load("w8a8")
    fn = lib.awq_quant_per_token
    _build.declare(fn, _build.P, _build.P, _build.P, *([_build.I] * 4), _build.P)
    err = fn(x.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, ic, DTYPE_CODE[x.dtype],
             int(perm), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "quant_per_token")
    LAUNCHES["quant_per_token"] += 1
    return xq, sx
