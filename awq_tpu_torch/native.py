"""ctypes bindings for the native repacker (``native/repack.cpp``): the
port's own copy of ``awq_tpu/native.py``, which the port does not import.

Builds the shared library lazily with g++ into ``build/`` under a name of
the port's own (``libawq_torch_repack.so``); every entry point has a
numpy version, the plain reference the tests hold the native one to, which
runs where no toolchain is. Which of the two ran is logged once, at the
first call. The repacker is host code: the
native path matters at 70B scale, where repacking third-party checkpoints
in Python dominates import time.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO, "native", "repack.cpp")
_LIB_PATH = os.path.join(_REPO, "build", "libawq_torch_repack.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    if not os.path.exists(_SRC):
        return None
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    if (os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)):
        return _LIB_PATH
    cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", _SRC,
           "-o", _LIB_PATH]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return _LIB_PATH
    except Exception:
        return None


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            path = _build()
            if path:
                try:
                    lib = ctypes.CDLL(path)
                    i64 = ctypes.c_int64
                    u8p = ctypes.POINTER(ctypes.c_uint8)
                    i16p = ctypes.POINTER(ctypes.c_int16)
                    i32p = ctypes.POINTER(ctypes.c_int32)
                    lib.unpack_awq_v2.argtypes = [i16p, i64, i64, u8p]
                    lib.unpack_awq_gemm.argtypes = [i32p, i64, i64, u8p]
                    lib.pack_int4_tpu.argtypes = [u8p, i64, i64, i32p]
                    lib.unpack_int4_tpu.argtypes = [i32p, i64, i64, u8p]
                    _lib = lib
                except OSError:
                    # stale/incompatible .so (e.g. different arch/libc with
                    # no toolchain to rebuild): use the numpy fallbacks
                    _lib = None
            log.info("awq_tpu_torch.native: repacking with %s",
                     f"the native library {_LIB_PATH}" if _lib is not None
                     else "the numpy versions (no native library)")
    return _lib


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


# ---------------------------------------------------------------------------
# numpy fallbacks (reference implementations; also the test oracle)
# ---------------------------------------------------------------------------


def _v2_inv_perm() -> np.ndarray:
    inv = np.empty(32, np.int64)
    for idx in range(32):
        a, b, d = idx // 8, (idx % 8) // 2, idx % 2
        p1 = 8 * b + 2 * a + d
        e, f = p1 // 8, p1 % 8
        g, h = f // 2, f % 2
        inv[8 * e + 4 * h + g] = idx
    return inv


def _np_unpack_awq_v2(packed: np.ndarray, N: int, K: int) -> np.ndarray:
    pw = packed.view(np.uint16).reshape(N // 4, K // 64, 64)
    nib = np.stack([(pw >> (4 * y)) & 0xF for y in range(4)], axis=-1)
    # flat = 4x + y = i*64 + ks
    nib = nib.reshape(N // 4, K // 64, 4, 64)       # [n4, kb, i, ks]
    inv = _v2_inv_perm()
    cols = (np.arange(64) // 32) * 32 + inv[np.arange(64) % 32]
    out = np.empty((N, K), np.uint8)
    for i in range(4):
        block = nib[:, :, i, :]                     # [n4, kb, ks]
        reord = np.empty_like(block)
        reord[:, :, cols] = block
        out[i::4][np.arange(N // 4)] = reord.reshape(N // 4, K)
    # rows: n = 4*n4 + i
    res = np.empty((N, K), np.uint8)
    for i in range(4):
        blk = nib[:, :, i, :]
        tmp = np.zeros((N // 4, K // 64, 64), np.uint8)
        tmp[:, :, cols] = blk
        res[i::4] = tmp.reshape(N // 4, K)
    return res


def _np_unpack_awq_gemm(packed: np.ndarray, K: int, N: int) -> np.ndarray:
    order = np.array([0, 2, 4, 6, 1, 3, 5, 7])
    pw = packed.view(np.uint32).reshape(K, N // 8)
    nib = np.stack([(pw >> (4 * s)) & 0xF for s in range(8)], axis=-1)
    out = np.empty((K, N // 8, 8), np.uint8)
    out[:, :, order] = nib.astype(np.uint8)
    return out.reshape(K, N)


def _np_pack_int4_tpu(codes: np.ndarray) -> np.ndarray:
    ic, oc = codes.shape
    qc = codes.reshape(ic // 64, 8, 8, oc).astype(np.uint32)
    packed = np.zeros((ic // 64, 8, oc), np.uint32)
    for s in range(8):
        packed |= qc[:, s] << (4 * s)
    return packed.reshape(ic // 8, oc).view(np.int32)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def native_available() -> bool:
    return _get_lib() is not None


def unpack_awq_v2(packed: np.ndarray, n: int, k: int) -> np.ndarray:
    """TinyChat v2 int16 ``[N/4, K]`` -> codes uint8 ``[N, K]``."""
    packed = np.ascontiguousarray(packed, np.int16)
    lib = _get_lib()
    if lib is None:
        return _np_unpack_awq_v2(packed, n, k)
    out = np.empty((n, k), np.uint8)
    lib.unpack_awq_v2(_ptr(packed, ctypes.c_int16), n, k,
                      _ptr(out, ctypes.c_uint8))
    return out


def unpack_awq_gemm(packed: np.ndarray, k: int, n: int) -> np.ndarray:
    """AutoAWQ GEMM int32 ``[K, N/8]`` -> codes uint8 ``[K, N]``."""
    packed = np.ascontiguousarray(packed, np.int32)
    lib = _get_lib()
    if lib is None:
        return _np_unpack_awq_gemm(packed, k, n)
    out = np.empty((k, n), np.uint8)
    lib.unpack_awq_gemm(_ptr(packed, ctypes.c_int32), k, n,
                        _ptr(out, ctypes.c_uint8))
    return out


def pack_int4_tpu(codes: np.ndarray) -> np.ndarray:
    """codes uint8 ``[IC, OC]`` -> awq_tpu packed int32 ``[IC/8, OC]``."""
    codes = np.ascontiguousarray(codes, np.uint8)
    ic, oc = codes.shape
    lib = _get_lib()
    if lib is None:
        return _np_pack_int4_tpu(codes)
    out = np.empty((ic // 8, oc), np.int32)
    lib.pack_int4_tpu(_ptr(codes, ctypes.c_uint8), ic, oc,
                      _ptr(out, ctypes.c_int32))
    return out


def unpack_int4_tpu(packed: np.ndarray, ic: int, oc: int) -> np.ndarray:
    packed = np.ascontiguousarray(packed, np.int32)
    lib = _get_lib()
    if lib is None:
        raise NotImplementedError("numpy fallback: use quant.packing")
    out = np.empty((ic, oc), np.uint8)
    lib.unpack_int4_tpu(_ptr(packed, ctypes.c_int32), ic, oc,
                        _ptr(out, ctypes.c_uint8))
    return out
