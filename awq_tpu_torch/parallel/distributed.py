"""Process-group bootstrap (PyTorch port of
``awq_tpu/parallel/distributed.py``).

The JAX package initializes multi-host JAX and builds one global mesh.
The port runs one process per rank and initializes ``torch.distributed``
in each, reading what ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) unless the caller
passes them. The backend is the caller's explicit choice:

- ``"nccl"`` when every rank owns a card of its own: NCCL refuses two
  ranks on one device, so this raises where ``LOCAL_RANK`` has no card of
  its own;
- ``"gloo"`` otherwise: several ranks sharing one card (gloo reduces
  CUDA tensors through the host), or ranks on the CPU.

A rank computes on a card under either backend; the CPU is only ever
asked for explicitly (``device="cpu"``, as the tests do). Nothing switches
the backend or the device quietly, and the rendezvous has a timeout.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

from awq_tpu_torch import _device
from awq_tpu_torch.parallel.mesh import MeshConfig, TPGroup, make_mesh

BACKENDS = ("nccl", "gloo")


def _env_int(name: str, given: Optional[int]) -> Optional[int]:
    if given is not None:
        return given
    return int(os.environ[name]) if name in os.environ else None


def init_distributed(backend: str, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     local_rank: Optional[int] = None, timeout_s: float = 120.0,
                     store=None, device=None) -> torch.device:
    """Initialize ``torch.distributed`` for this rank, make its card the
    current device and return the device it computes on: ``cuda:LOCAL_RANK``
    under NCCL, ``cuda:(LOCAL_RANK % cards)`` under gloo (ranks may share a
    card); without a card this raises, unless ``device="cpu"`` asks for the
    CPU (gloo only). ``init_method`` (``"tcp://host:port"``,
    ``"file://..."``) or a ``store`` (e.g. a ``torch.distributed.FileStore``)
    overrides ``MASTER_ADDR``/``MASTER_PORT``; no rank waits longer than
    ``timeout_s`` for the others."""
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if device is not None and torch.device(device).type != "cpu":
        raise ValueError("init_distributed places a rank on its card itself; device "
                         f"takes only 'cpu', not {device!r}")
    rank = _env_int("RANK", rank)
    world_size = _env_int("WORLD_SIZE", world_size)
    if rank is None or world_size is None:
        raise ValueError("init_distributed needs the rank and the world size "
                         "(arguments, or RANK and WORLD_SIZE as torchrun sets them)")
    local_rank = _env_int("LOCAL_RANK", local_rank)
    local_rank = rank if local_rank is None else local_rank
    if device is not None:
        if backend == "nccl":
            raise ValueError("nccl runs on cards only; device='cpu' needs backend='gloo'")
        device = torch.device("cpu")
    elif backend == "nccl":
        n = torch.cuda.device_count()
        if local_rank >= n:
            raise RuntimeError(
                f"nccl: local rank {local_rank} has no card of its own ({n} visible); "
                "NCCL refuses two ranks on one device. Run one rank per card, or "
                "backend='gloo' for ranks that share a card")
        device = torch.device("cuda", local_rank)
    else:
        _device.resolve("cuda")                  # raises without a card
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if store is None and init_method is None and "MASTER_ADDR" not in os.environ:
        raise ValueError("init_distributed needs init_method, a store or "
                         "MASTER_ADDR/MASTER_PORT")
    dist.init_process_group(backend=backend, init_method=init_method, store=store,
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def make_multihost_mesh(tp: Optional[int] = None, device=None) -> TPGroup:
    """This rank's group in a layout over the whole world: ``tp`` defaults
    to the ranks of one host (``LOCAL_WORLD_SIZE``, else the visible cards,
    at least 1), so that a group's collectives stay on one host; the
    remaining ranks form ``dp``."""
    import torch.distributed as dist

    world = dist.get_world_size()
    tp = tp or int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or max(torch.cuda.device_count(), 1)
    while world % tp != 0:
        tp //= 2
    return make_mesh(MeshConfig(dp=world // tp, tp=tp), device=device)
