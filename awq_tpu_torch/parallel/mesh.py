"""Tensor-parallel groups and shape selection (PyTorch port of
``awq_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``jax.sharding.Mesh`` with a
``dp`` and a ``tp`` axis. PyTorch runs one process per rank instead, so
the port's counterpart of a mesh is :class:`TPGroup`: this process's rank
in its tensor-parallel group, the group's size, the ``torch.distributed``
process group that its collectives run over, and the device the rank
computes on. ``dp`` is kept in the shape (:class:`MeshConfig`), and the
ranks of a ``dp > 1`` layout form ``dp`` groups of ``tp``; the engines
take ``dp == 1`` only, as the JAX engines do.

:func:`pick_mesh_shape` and :func:`parse_mesh_arg` equal the JAX
package's on the same inputs; :func:`parse_mesh_arg` returns the shape,
and :func:`make_mesh` turns it into this process's group once
``torch.distributed`` is initialized (``parallel/distributed.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from awq_tpu_torch import _device


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    tp: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp


def pick_mesh_shape(n_params_b: float, n_devices: Optional[int] = None,
                    max_tp: int = 8) -> MeshConfig:
    """Choose (dp, tp) from the model size and the devices: enough ``tp``
    to fit the model (about 0.6 GB per billion parameters at W4 against 8
    GB per device, half of a 16 GB part), the rest ``dp``. ``n_devices``
    defaults to the visible CUDA devices."""
    n = n_devices if n_devices is not None else torch.cuda.device_count()
    tp = 1
    while tp < min(n, max_tp) and n_params_b * 0.6 > 8.0 * tp:
        tp *= 2
    while n % tp != 0:
        tp //= 2
    return MeshConfig(dp=n // tp, tp=tp)


def parse_mesh_arg(s: Optional[str]) -> Optional[MeshConfig]:
    """CLI ``--mesh 'dp,tp'`` (or just ``'tp'``) -> the shape; None/'' ->
    None."""
    if not s:
        return None
    parts = [int(x) for x in s.split(",")]
    dp, tp = (1, parts[0]) if len(parts) == 1 else parts
    return MeshConfig(dp=dp, tp=tp)


@dataclasses.dataclass
class TPGroup:
    """This process's place in a tensor-parallel group: ``rank`` of
    ``size``, the ``torch.distributed`` process ``group`` of those ranks,
    the ``device`` the rank computes on, and the layout's ``dp`` (the
    number of data-parallel groups of ``size`` ranks each)."""

    rank: int
    size: int
    group: Any
    device: torch.device
    dp: int = 1

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group's ranks, in place; returns ``t``."""
        import torch.distributed as dist

        dist.all_reduce(t, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src_rank: int = 0) -> torch.Tensor:
        """``t`` of the group's rank ``src_rank`` on every rank, in place."""
        import torch.distributed as dist

        dist.broadcast(t, src=dist.get_global_rank(self.group, src_rank),
                       group=self.group)
        return t


def make_mesh(cfg: Optional[MeshConfig] = None, device=None) -> TPGroup:
    """This process's :class:`TPGroup` in a ``cfg`` layout over the
    initialized ``torch.distributed`` world (default: one group of every
    rank). Global rank ``r`` is rank ``r % tp`` of data-parallel group
    ``r // tp``: ``tp`` is the fastest-varying axis, as in the JAX mesh.
    Every rank must call this, in the same order (``new_group`` is
    collective). ``device``: the rank's device, by default the current CUDA
    device whatever the backend (``init_distributed`` sets it); without a
    card this raises, and ranks on the CPU pass ``device="cpu"``."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized "
                           "(awq_tpu_torch.parallel.distributed.init_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if cfg is None:
        cfg = MeshConfig(dp=1, tp=world)
    if cfg.n_devices != world:
        raise ValueError(f"mesh {cfg} needs {cfg.n_devices} ranks, the world has {world}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else "cuda")
    device = _device.resolve(device)
    if cfg.dp == 1:
        group = dist.group.WORLD
    else:
        groups = [dist.new_group(ranks=list(range(d * cfg.tp, (d + 1) * cfg.tp)))
                  for d in range(cfg.dp)]
        group = groups[rank // cfg.tp]
    return TPGroup(rank=rank % cfg.tp, size=cfg.tp, group=group,
                   device=device, dp=cfg.dp)
