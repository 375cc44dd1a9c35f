"""Sub-byte weight packing (PyTorch port of ``awq_tpu/quant/packing.py``).

Runtime layout (``pack_int4``), identical to the JAX package's so that
checkpoints and parameter trees carry across bit for bit:

``q [IC, OC] (codes 0..15)  ->  packed int32 [IC//8, OC]``

Within each chunk of 64 input channels, the code for input channel
``ic = 64*c + 8*s + r`` lives in word ``p = 8*c + r`` at nibble slot ``s``
(bits ``4s..4s+3``). The nibble order is therefore NOT contiguous in
``ic``: the eight nibbles of one word are eight input channels eight
apart. The CUDA W4A16 kernels (``csrc/w4a16.cuh``) read this layout as it
is; there is no repack at load time.

INT3 runtime layout (``pack_int3``), also the JAX package's: codes
``[IC, OC]`` (values < 8) -> int32 ``[IC*3//32, OC]``, true 3-bit density
(0.75x the bytes of the nibble container). Per 256-channel chunk ``c`` (24
words), the code of input channel ``ic = 256c + 8s + r`` (``s < 32``,
``r < 8``) keeps its low 2 bits in word ``24c + 8(s >> 4) + r`` at bits
``2(s & 15)`` and its high bit in word ``24c + 16 + r`` at bit ``s``. It
needs ``IC % 256 == 0``; otherwise 3-bit codes live in the nibble
container. ``pack_int3_dense`` is the bitplane codec for checkpoints. The
CUDA W3 kernels (``csrc/w4a16.cuh``, the megakernels' W3 mode) read
``pack_int3`` as stored.
"""

from __future__ import annotations

import torch

PACK_FACTOR = 8   # int4 codes per int32 word
PACK_CHUNK = 64   # input channels per packing chunk


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack uint8 codes ``[IC, OC]`` (values < 16) into int32 ``[IC//8, OC]``."""
    ic, oc = q.shape
    if ic % PACK_CHUNK != 0:
        raise ValueError(f"IC={ic} must be divisible by {PACK_CHUNK}")
    # [c, s, r, oc]; int64 holds the full 32-bit pattern without sign trouble
    qc = q.reshape(ic // PACK_CHUNK, 8, 8, oc).to(torch.int64)
    packed = torch.zeros((ic // PACK_CHUNK, 8, oc), dtype=torch.int64,
                         device=q.device)
    for s in range(8):
        packed |= qc[:, s] << (4 * s)
    # reinterpret the low 32 bits as int32 (two's complement)
    packed = torch.where(packed >= 2**31, packed - 2**32, packed)
    return packed.reshape(ic // PACK_FACTOR, oc).to(torch.int32)


def unpack_int4(packed: torch.Tensor, out_dtype=torch.uint8) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: int32 ``[IC//8, OC]`` -> codes ``[IC, OC]``."""
    icp, oc = packed.shape
    w = packed.reshape(icp // 8, 8, oc)
    # arithmetic shift of a negative int32 smears the sign bit, but the
    # 0xF mask keeps only the nibble, so the result is the same as a
    # logical shift
    planes = [(w >> (4 * s)) & 0xF for s in range(8)]
    out = torch.stack(planes, dim=1).reshape(icp * 8, oc)
    return out.to(out_dtype)


INT3_CHUNK = 256        # input channels per pack_int3 chunk
INT3_ROWS = 24          # packed words per chunk (16 lo + 8 hi)


def _as_int32(packed: torch.Tensor) -> torch.Tensor:
    """int64 words holding 32-bit patterns -> int32 (two's complement)."""
    packed = torch.where(packed >= 2**31, packed - 2**32, packed)
    return packed.to(torch.int32)


def _as_uint(packed: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 holding the unsigned 32-bit pattern."""
    return packed.to(torch.int64) & 0xFFFFFFFF


def pack_int3(q: torch.Tensor) -> torch.Tensor:
    """Pack uint8 codes ``[IC, OC]`` (values < 8) into the dense 3-bit
    runtime layout: int32 ``[IC*3//32, OC]`` (see module docstring)."""
    ic, oc = q.shape
    if ic % INT3_CHUNK != 0:
        raise ValueError(f"IC={ic} must be divisible by {INT3_CHUNK}")
    nc = ic // INT3_CHUNK
    qc = q.reshape(nc, 32, 8, oc).to(torch.int64)          # [c, s, r, oc]
    lo = torch.zeros((nc, 2, 8, oc), dtype=torch.int64, device=q.device)
    hi = torch.zeros((nc, 8, oc), dtype=torch.int64, device=q.device)
    for s in range(32):
        lo[:, s >> 4] |= (qc[:, s] & 3) << (2 * (s & 15))
        hi |= (qc[:, s] >> 2) << s
    rows = torch.cat([lo.reshape(nc, 16, oc), hi], dim=1)
    return _as_int32(rows.reshape(nc * INT3_ROWS, oc))


def unpack_int3(packed: torch.Tensor, out_dtype=torch.uint8) -> torch.Tensor:
    """Inverse of :func:`pack_int3`: int32 ``[IC*3//32, OC]`` -> codes
    ``[IC, OC]``."""
    nrows, oc = packed.shape
    nc = nrows // INT3_ROWS
    w = _as_uint(packed).reshape(nc, INT3_ROWS, oc)
    lo = w[:, :16].reshape(nc, 2, 8, oc)                   # [c, g, r, oc]
    hi = w[:, 16:]                                         # [c, r, oc]
    planes = [((lo[:, s >> 4] >> (2 * (s & 15))) & 3) | (((hi >> s) & 1) << 2)
              for s in range(32)]
    out = torch.stack(planes, dim=1)                       # [c, s, r, oc]
    return out.reshape(nc * INT3_CHUNK, oc).to(out_dtype)


def pack_int3_dense(q: torch.Tensor) -> torch.Tensor:
    """Bitplane-pack codes ``[IC, OC]`` (values < 8) into int32
    ``[3, IC//32, OC]`` (checkpoint storage): bit ``b`` of the code at
    ``ic = 32c + j`` is bit ``j`` of ``packed[b, c]``."""
    ic, oc = q.shape
    if ic % 32 != 0:
        raise ValueError(f"IC={ic} must be divisible by 32")
    qc = q.reshape(ic // 32, 32, oc).to(torch.int64)
    planes = []
    for b in range(3):
        bit = (qc >> b) & 1
        word = torch.zeros((ic // 32, oc), dtype=torch.int64, device=q.device)
        for j in range(32):
            word |= bit[:, j] << j
        planes.append(word)
    return _as_int32(torch.stack(planes, dim=0))


def unpack_int3_dense(packed: torch.Tensor, out_dtype=torch.uint8) -> torch.Tensor:
    """Inverse of :func:`pack_int3_dense` -> codes ``[IC, OC]``."""
    _, c, oc = packed.shape
    w = _as_uint(packed)
    cols = [((w[0] >> j) & 1) | (((w[1] >> j) & 1) << 1) | (((w[2] >> j) & 1) << 2)
            for j in range(32)]
    return torch.stack(cols, dim=1).reshape(c * 32, oc).to(out_dtype)
