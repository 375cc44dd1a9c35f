"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"``. Without a card they raise
instead of carrying on on the CPU: a CPU run is only ever asked for
explicitly (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device]


def resolve(device: Device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"awq_tpu_torch: device {str(device)!r} asked for, but "
            "torch.cuda.is_available() is False. Pass device='cpu' to run "
            "the plain PyTorch versions of the kernels on the CPU.")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"awq_tpu_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev
