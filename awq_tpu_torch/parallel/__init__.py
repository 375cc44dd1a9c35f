"""Tensor parallelism over ``torch.distributed`` (PyTorch port of
``awq_tpu/parallel``): groups (``mesh``), the bootstrap (``distributed``),
a rank's shards (``shard``) and deploy layout (``deploy``), and the
tensor-parallel forward and decode (``tp``)."""

from awq_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshConfig,
    TPGroup,
    make_mesh,
    parse_mesh_arg,
    pick_mesh_shape,
)
from awq_tpu_torch.parallel.shard import shard_cache, shard_params  # noqa: F401
from awq_tpu_torch.parallel.tp import (  # noqa: F401
    check_tp_compatible,
    tp_decode_scan,
    tp_forward,
    tp_local_cfg,
)
from awq_tpu_torch.parallel.deploy import build_tp_params  # noqa: F401
