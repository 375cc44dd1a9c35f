"""Carry a JAX parameter tree of ``awq_tpu`` across to the port, bit for bit.

:func:`params_from_jax` takes the tree after ``jax.device_get`` (every leaf
a numpy array) and reads its ``QLinear`` and ``Linear`` leaves by
attribute, so this module imports nothing of the JAX package. It accepts
the unfused tree of ``quantize_params`` and the tree fused by
``fuse_linears(..., tile=False)``; the TPU-only tiled, folded and dense-3
layouts are refused.
"""

from __future__ import annotations

import numpy as np
import torch

from awq_tpu_torch import _device
from awq_tpu_torch.models.layers import Linear
from awq_tpu_torch.ops.w4a16 import QLinear


def _tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


def params_from_jax(tree, device="cuda"):
    """The port's parameter tree from a host copy of a JAX one."""
    dev = _device.resolve(device)

    def conv(x, path):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v, f"{path}/{k}") for k, v in x.items()}
        if hasattr(x, "qweight"):
            if (getattr(x, "tiled_bn", 0) or getattr(x, "folded", False)
                    or getattr(x, "dense3", False)):
                raise ValueError(
                    f"{path}: tiled/folded/dense-3 QLinear layouts exist only "
                    "for the TPU kernels; convert params fused with "
                    "fuse_linears(..., tile=False), or unfused ones")
            if x.w_bit != 4:
                raise NotImplementedError(
                    f"{path}: w_bit={x.w_bit}; W3 is ROADMAP queue A, item 13")
            return QLinear(qweight=_tensor(x.qweight, dev),
                           scales=_tensor(x.scales, dev),
                           szeros=_tensor(x.szeros, dev),
                           bias=conv(x.bias, f"{path}.bias"),
                           w_bit=int(x.w_bit), group_size=int(x.group_size))
        if hasattr(x, "w"):
            return Linear(w=_tensor(x.w, dev), b=conv(x.b, f"{path}.b"))
        if isinstance(x, (np.ndarray, np.generic)) or hasattr(x, "__array__"):
            return _tensor(x, dev)
        raise TypeError(f"{path}: unsupported leaf {type(x).__name__}")

    return conv(tree, "params")
