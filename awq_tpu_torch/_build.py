"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each unit of :data:`UNITS` is one ``csrc/<source>.cu`` with a set of
``-D`` defines, exposes a plain C interface (``extern "C"``) and is
compiled on its own into ``build/awq_tpu_torch/<unit>-<hash>.so`` at the
repository root, where ``<hash>`` covers the source, every header of
``csrc/`` (so any header a unit includes), the defines and the compiler
flags: an edited source or header builds anew, an unchanged one is loaded
from disk. The megakernels are built once per instance: K4
(``megakernel.cu``) per weight format and layer shape (llama, MPT), the
flash attention (``decode_attn.cu``) without ALiBi slopes (head_dim 128 and
up to 32 q heads a kv head; the wide unit the other shapes), with them, and
in its window mode (the batched speculative verify, unit
``decode_attn_verify``), K6 (``megakernel_batched.cu``) per
cache (the four slot dtypes and the page pool) and format, and K5, the
chunk mode of K6's body (``AWQ_MEGA_CHUNK``), per cache dtype and format,
so that the instances compile in parallel. Nothing here runs at import
time; the op modules call :func:`load` on their first launch, and
:func:`build_all` starts one ``nvcc`` per unit at once (the smoke script
uses it to build in parallel and to time the build).

Pointers and the stream cross ctypes as ``c_void_p`` and sizes as
``c_int``: an undeclared argument would be passed as a
32-bit int and cut a pointer. Every entry returns the ``cudaError_t`` of
its launch, and :func:`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "awq_tpu_torch"
_CT = {"f32": "float", "bf16": "bf16", "f16": "__half", "int8": "int8_t"}
_FORMATS = (("", 0), ("_w3", 1))     # unit suffix, -DAWQ_MEGA_W3
#: Unit name -> (source stem in csrc/, defines).
UNITS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "w4a16": ("w4a16", ()), "w3a16": ("w3a16", ()), "decode_attn": ("decode_attn", ()),
    # K2, K8 and K9 at head_dim 64 and wide query groups (entries *_wide)
    "decode_attn_wide": ("decode_attn", ("AWQ_DECODE_WIDE=1",)),
    # K2, K3, K8, K9 and K14 with ALiBi slopes compiled in (entries *_alibi)
    "decode_attn_alibi": ("decode_attn", ("AWQ_ALIBI=1",)),
    # the window mode of K2 and K9, the batched speculative verify (entries
    # awq_flash_verify, awq_flash_verify_int8)
    "decode_attn_verify": ("decode_attn", ("AWQ_DECODE_VERIFY=1",)),
    **{f"megakernel{sfx}": ("megakernel", (f"AWQ_MEGA_W3={w}",)) for sfx, w in _FORMATS},
    # K4's MPT shape (bias-free LayerNorm, ALiBi, the erf-GELU plain MLP)
    **{f"megakernel_mpt{sfx}": ("megakernel", (f"AWQ_MEGA_W3={w}", "AWQ_MEGA_MPT=1"))
       for sfx, w in _FORMATS},
    **{f"megakernel_chunk_{c}{sfx}": ("megakernel_batched",
                                      (f"AWQ_MEGA_CT={_CT[c]}", "AWQ_MEGA_PAGED=0",
                                       f"AWQ_MEGA_W3={w}", "AWQ_MEGA_CHUNK=1"))
       for c in ("f32", "bf16", "f16") for sfx, w in _FORMATS},
    **{f"megakernel_batched_{c}{sfx}": (
        "megakernel_batched",
        (f"AWQ_MEGA_CT={_CT.get(c, 'bf16')}", f"AWQ_MEGA_PAGED={int(c == 'paged')}",
         f"AWQ_MEGA_W3={w}"))
       for c in ("f32", "bf16", "f16", "int8", "paged") for sfx, w in _FORMATS},
    "cache_append": ("cache_append", ()), "w8a8": ("w8a8", ()),
}
SOURCES = tuple(UNITS)
ARCH = "sm_90a"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-lineinfo",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME and /usr/local/cuda): "
        "the CUDA kernels of awq_tpu_torch are built at first use")


def _digest(name: str) -> str:
    src, defines = UNITS[name]
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{src}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS + defines).encode())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _compile_cmd(name: str, out: Path) -> List[str]:
    src, defines = UNITS[name]
    return [nvcc_path(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-I", str(CSRC),
            "-o", str(out), str(CSRC / f"{src}.cu")]


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    ``(process, tmp_path, final_path)`` or None. nvcc writes its output to
    the log beside the library (a pipe could fill and stall it)."""
    final = lib_path(name)
    if final.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", prefix=f".{name}-", dir=BUILD_DIR)
    os.close(fd)
    with open(BUILD_DIR / f"{final.stem}.log", "w") as log:
        proc = subprocess.Popen(_compile_cmd(name, Path(tmp)), stdout=log,
                                stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), final


def _finish(name: str, started) -> str:
    proc, tmp, final = started
    proc.wait()
    log = (BUILD_DIR / f"{final.stem}.log").read_text()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for unit {name} (csrc/{UNITS[name][0]}.cu) "
                           f"(exit {proc.returncode}):\n{log}")
    # atomic: another process building the same source writes the same bytes
    os.replace(tmp, final)
    return log


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every unit that has no library yet, one nvcc each, all
    started together. Returns the seconds from the start to each build's
    end (0 if cached)."""
    names = list(names)
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    took = {n: 0.0 for n in names if started[n] is None}
    while len(took) < len(names):
        for n in names:
            if n not in took and started[n][0].poll() is not None:
                took[n] = time.perf_counter() - t0
        time.sleep(0.05)
    for n in names:
        if started[n] is not None:
            _finish(n, started[n])
    return took


def build_log(name: str) -> str:
    """nvcc's output for the current library (registers, spills)."""
    path = BUILD_DIR / f"{lib_path(name).stem}.log"
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of unit ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = ctypes.CDLL(str(lib_path(name)))
            lib.awq_error_string.restype = ctypes.c_char_p
            lib.awq_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
        return lib


def declare(fn, *argtypes) -> None:
    """Set a C entry's signature (idempotent); all entries return int."""
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.awq_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({msg})")


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
