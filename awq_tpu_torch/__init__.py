"""awq_tpu_torch — the PyTorch and CUDA port of awq_tpu for NVIDIA Hopper.

It mirrors the JAX package's module names (``config``, ``quant``, ``ops``,
``models``, ``runtime``, ``serve``, ``parallel``) and holds itself to that package in its tests,
but imports nothing of it. Plain tensor code is PyTorch; the hot kernels
are written by hand in CUDA C++ for ``sm_90a`` (``csrc/``) and built with
``nvcc`` at first use (``_build``). Entry points default to
``device="cuda"`` and raise without a card; ``device="cpu"`` runs every
kernel's plain PyTorch version instead.
"""

__version__ = "0.1.0"
