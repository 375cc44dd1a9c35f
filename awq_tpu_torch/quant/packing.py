"""Sub-byte weight packing (PyTorch port of ``awq_tpu/quant/packing.py``).

Runtime layout (``pack_int4``), identical to the JAX package's so that
checkpoints and parameter trees carry across bit for bit:

``q [IC, OC] (codes 0..15)  ->  packed int32 [IC//8, OC]``

Within each chunk of 64 input channels, the code for input channel
``ic = 64*c + 8*s + r`` lives in word ``p = 8*c + r`` at nibble slot ``s``
(bits ``4s..4s+3``). The nibble order is therefore NOT contiguous in
``ic``: the eight nibbles of one word are eight input channels eight
apart. The CUDA W4A16 kernels (``csrc/w4a16.cu``) read this layout as it
is; there is no repack at load time.

W3 packing (``pack_int3``) is not ported yet.
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
